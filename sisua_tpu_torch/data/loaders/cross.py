"""Cross-dataset harmonization, the shared-gene PBMC panel (port of
``sisua_tpu/data/loaders/cross.py``): the gene sets of several PBMC
cohorts intersected so that a model trained on one evaluates on another
(the registry's '8kx', 'eccx', …), and an ablation that drops chosen
proteins (CD4/CD8) from the label panel.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..const import OMIC
from ..dataset import SingleCellOMIC

__all__ = ["read_PBMC_crossdataset", "read_PBMC_crossdataset_remove_protein"]


def _cohort_loaders() -> Dict[str, Callable[[], SingleCellOMIC]]:
  from .citeseq import read_CITEseq_CBMC, read_CITEseq_PBMC
  from .leukemia import read_leukemia_BMMC, read_leukemia_MixedPhenotypes
  from .pbmc8k import read_PBMC8k
  from .pbmcecc import read_PBMCeec
  from .tenx import read_dataset10x
  return {
      "8k": lambda: read_PBMC8k("full"),
      "ecc": lambda: read_PBMCeec("full"),
      "pbmc": read_CITEseq_PBMC,
      "cbmc": read_CITEseq_CBMC,
      "call": read_leukemia_BMMC,
      "mpal": lambda: read_leukemia_MixedPhenotypes(omic="rna"),
      "5k": lambda: read_dataset10x("5k_pbmc_protein_v3"),
      "vdj1": lambda: read_dataset10x("vdj_v1_hs_aggregated_donor1"),
      "vdj4": lambda: read_dataset10x("vdj_v1_hs_aggregated_donor4"),
  }


def read_PBMC_crossdataset(name: str = "8k",
                           cohorts: Optional[Sequence[str]] = None,
                           override: bool = False,
                           verbose: bool = True) -> SingleCellOMIC:
  """Return cohort ``name`` restricted to the genes (and proteins) shared by
  all ``cohorts`` (default: every cohort that loads in this environment)."""
  loaders = _cohort_loaders()
  if name not in loaders:
    raise KeyError(f"unknown cohort '{name}'; known {list(loaders)}")
  cohorts = list(cohorts or loaders.keys())
  scos: Dict[str, SingleCellOMIC] = {}
  failed: List[str] = []
  for c in cohorts:
    try:
      scos[c] = loaders[c]()
    except Exception as e:  # offline / missing cache cohorts are skipped
      failed.append(f"{c}: {e}")
  if name not in scos:
    raise RuntimeError(
        f"Cross-dataset target '{name}' unavailable. Failures:\n  "
        + "\n  ".join(failed))
  shared_genes = None
  shared_prots = None
  for sco in scos.values():
    g = set(map(str, sco.get_var_names(OMIC.transcriptomic)))
    shared_genes = g if shared_genes is None else (shared_genes & g)
    if "proteomic" in sco.omics:
      p = set(map(str, sco.get_var_names(OMIC.proteomic)))
      shared_prots = p if shared_prots is None else (shared_prots & p)
  target = scos[name]
  gidx = target.get_var_indices(OMIC.transcriptomic)
  keep_g = sorted(shared_genes)
  out = target.copy()
  out.set_omic(OMIC.transcriptomic)
  out.apply_indices([gidx[g] for g in keep_g], observation=False)
  if shared_prots and "proteomic" in out.omics:
    pidx = out.get_var_indices(OMIC.proteomic)
    keep_p = sorted(shared_prots)
    out.set_omic(OMIC.proteomic)
    out.apply_indices([pidx[p] for p in keep_p], observation=False)
    out.set_omic(OMIC.transcriptomic)
  out._name = f"{name}_cross"
  if verbose and failed:
    print(f"[cross] skipped cohorts: {failed}")
  return out


def read_PBMC_crossdataset_remove_protein(
    name: str = "8k",
    remove_proteins: Sequence[str] = ("CD4", "CD8"),
    override: bool = False,
    verbose: bool = True) -> SingleCellOMIC:
  """Ablation: the cross-dataset panel with chosen proteins dropped."""
  sco = read_PBMC_crossdataset(name, override=override, verbose=verbose)
  if "proteomic" not in sco.omics:
    return sco
  names = list(map(str, sco.get_var_names(OMIC.proteomic)))
  remove = {p.lower() for p in remove_proteins}
  keep = [i for i, n in enumerate(names) if n.lower() not in remove]
  sco.set_omic(OMIC.proteomic)
  sco.apply_indices(keep, observation=False)
  sco.set_omic(OMIC.transcriptomic)
  sco._name = f"{name}_cross_noprot"
  return sco

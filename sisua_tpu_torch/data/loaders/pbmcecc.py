"""PBMC ECC loader, the cross-dataset partner of pbmc8k (port of
``sisua_tpu/data/loaders/pbmcecc.py``): a second PBMC CITE-seq cohort for
cross-dataset evaluation, with the same ly/my subsets, the paper's
``ecc*`` sets.

Acquisition order as in pbmc8k.py: (1) the author-preprocessed 'ly'
bundle on public S3 (real ADT; only the lymphoid subset is published),
then
(2) an offline rebuild from the public 10x pbmc4k run (a disjoint donor)
through the same derivation pipeline as pbmc8k.
"""

from __future__ import annotations

import os

import numpy as np

from ..const import OMIC, MARKER_ADT_GENE
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR
from ..utils import load_from_dataset, save_to_dataset, validate_data_dir
from .pbmc8k import (_LYMPHOID_MARKERS, _MYELOID_MARKERS,
                     _fetch_author_bundle, _sco_from_author_cache)
from .tenx import read_dataset10x

# only 'ly' is published
_AUTHOR_BUNDLES = {
    "ly": "https://s3.amazonaws.com/ai-datasets/pbmcecc_ly.npz",
}

__all__ = ["read_PBMCeec"]


def read_PBMCeec(subset: str = "ly",
                 override: bool = False,
                 verbose: bool = True,
                 filtered_genes: bool = True) -> SingleCellOMIC:
  subset = str(subset).strip().lower()
  if subset not in ("full", "ly", "my"):
    raise ValueError(f"subset must be 'full'|'ly'|'my', given {subset}")
  cache = os.path.join(
      DATA_DIR,
      f"pbmcecc_{subset}{'' if filtered_genes else 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    if _fetch_author_bundle(_AUTHOR_BUNDLES, subset, filtered_genes, cache,
                            verbose):
      return _sco_from_author_cache(cache, f"pbmcecc_{subset}")
    base = read_dataset10x("pbmc4k", filtered_genes=filtered_genes,
                           override=override, verbose=verbose)
    X = base.numpy(OMIC.transcriptomic)
    genes = np.asarray(base.get_var_names(OMIC.transcriptomic), str)
    gi = {g: i for i, g in enumerate(genes)}
    ly = np.log1p(X[:, [gi[g] for g in _LYMPHOID_MARKERS if g in gi]]).sum(1)
    my = np.log1p(X[:, [gi[g] for g in _MYELOID_MARKERS if g in gi]]).sum(1)
    is_ly = ly >= my
    keep = (np.nonzero(is_ly)[0] if subset == "ly" else
            np.nonzero(~is_ly)[0] if subset == "my" else np.arange(len(is_ly)))
    prog = np.stack([is_ly[keep], ~is_ly[keep]], 1).astype(np.float32)
    save_to_dataset(cache, X[keep], genes, y=prog,
                    y_col=np.array(["lymphoid", "myeloid"]),
                    rowname=np.asarray(base.obs_names, str)[keep],
                    print_log=verbose)
  if os.path.isfile(os.path.join(cache, "cell_types.npz")):
    return _sco_from_author_cache(cache, f"pbmcecc_{subset}")
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=f"pbmcecc_{subset}")
  genes = {g: i for i, g in enumerate(np.asarray(X_col, str))}
  prots = [(p, genes[g]) for p, g in MARKER_ADT_GENE.items() if g in genes]
  if prots:
    import scipy.sparse as sp
    Xd = np.asarray(X.todense()) if sp.issparse(X) else X
    sco.add_omic(OMIC.proteomic,
                 np.stack([Xd[:, i] for _, i in prots], 1).astype(np.float32),
                 np.array([p for p, _ in prots]))
    sco.uns["proteomic_is_surrogate"] = True
  if y is not None:
    sco.add_omic(OMIC.progenitor, y, y_col)
  return sco

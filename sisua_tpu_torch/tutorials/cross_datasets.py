"""Cross-dataset evaluation: train on one cohort, evaluate the posterior
on another, the generalization test of the SISUA paper (port of
``tutorials/cross_datasets.py``). Offline, two synthetic cohorts drawn
from different seeds stand in (the same gene and protein panel).

  python -m sisua_tpu_torch.tutorials.cross_datasets
  python -m sisua_tpu_torch.tutorials.cross_datasets --device cpu
"""

from __future__ import annotations

from ._common import at_depth, device_of, run_cli

EPOCHS = 10


def cohorts():
  from ..data import generate_synthetic
  ds_a = generate_synthetic(n_cells=2000, n_genes=120, n_proteins=8,
                            n_celltypes=4, seed=1, name="cohortA")
  ds_b = generate_synthetic(n_cells=1000, n_genes=120, n_proteins=8,
                            n_celltypes=4, seed=2, name="cohortB")
  return ds_a, ds_b


def build(ds_a, device):
  from ..data import OMIC
  from ..models import SISUA, RVmeta
  return SISUA(outputs=[RVmeta(ds_a.n_vars, "zinb", name="rna"),
                        RVmeta(ds_a.get_dim(OMIC.proteomic), "nb",
                               name="adt")],
               latents=RVmeta(10, "diag", name="latents"), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data.adapters import fit_sco, sco_posterior
  dev = device_of(device)

  # --- 1. two cohorts over the same panel ----------------------------------------
  ds_a, ds_b = cohorts()
  # with real data: ds_a = get_dataset('8kly'); ds_b = get_dataset('eccly')

  # --- 2. train on cohort A ---------------------------------------------------------
  model = build(ds_a, dev)
  train, test_a = ds_a.split(0.8)
  fit_sco(model, train, valid=test_a, epochs=at_depth(EPOCHS, depth),
          batch_size=64, labels_percent=0.5, verbose=True)

  # --- 3. evaluate on both: in-cohort against cross-cohort ---------------------------
  result = {}
  for tag, test in (("in-cohort (A)", test_a), ("cross-cohort (B)", ds_b)):
    post = sco_posterior(model, test)
    imp = post.cal_imputation_scores()
    f1 = post.cal_protein_classification()
    got = {"imputation_med": imp["imputation_med"],
           "F1": f1.get("f1_F1macro", float("nan"))}
    print(f"{tag:18s} imputation_med={got['imputation_med']:.3f} "
          f"F1={got['F1']:.3f}")
    result[tag] = got
  return result


if __name__ == "__main__":
  run_cli(main, __doc__)

"""Basics: load → train → analyze (port of ``tutorials/basics.py``).

Runs offline on the synthetic dataset (3,000 cells × 558 genes + 10
proteins): a VAE and a semi-supervised SISUA with 10% protein labels,
their posteriors, and one ``ResultsSheet`` of both.

  python -m sisua_tpu_torch.tutorials.basics            # on the card
  python -m sisua_tpu_torch.tutorials.basics --device cpu
"""

from __future__ import annotations

import os

from ._common import at_depth, device_of, draw, out_dir_of, run_cli

EPOCHS = 15


def build_vae(sco, device):
  from ..models import VAE, NetConf, RVmeta
  return VAE(outputs=RVmeta(sco.n_vars, "zinb", name="rna"),
             latents=RVmeta(10, "diag", name="latents"),
             encoder=NetConf((64, 64), batchnorm=True, input_dropout=0.3),
             device=device)


def build_sisua(sco, device):
  from ..data import OMIC
  from ..models import SISUA, RVmeta
  return SISUA(outputs=[RVmeta(sco.n_vars, "zinb", name="rna"),
                        RVmeta(sco.get_dim(OMIC.proteomic), "nb",
                               name="adt")],
               latents=RVmeta(10, "diag", name="latents"), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..analysis import ResultsSheet
  from ..data import get_dataset
  from ..data.adapters import fit_sco, sco_posterior
  dev, out = device_of(device), out_dir_of(out_dir, "basics")
  epochs = at_depth(EPOCHS, depth)

  # --- 1. dataset -----------------------------------------------------------
  sco = get_dataset("synthetic")
  print(sco)
  train, test = sco.split(train_percent=0.8)

  # --- 2. an unsupervised VAE -----------------------------------------------
  vae = build_vae(sco, dev)
  fit_sco(vae, train, valid=test, epochs=epochs, batch_size=64, verbose=True)

  # --- 3. a semi-supervised SISUA with 10% protein labels -------------------
  sisua = build_sisua(sco, dev)
  fit_sco(sisua, train, valid=test, epochs=epochs, batch_size=64,
          labels_percent=0.1, verbose=True)

  # --- 4. posterior analysis -------------------------------------------------
  result, posteriors = {}, []
  for model in (vae, sisua):
    post = sco_posterior(model, test)
    posteriors.append(post)
    print(f"\n=== {model.id} ===")
    got = {"imputation": post.cal_imputation_scores(),
           "marker_spearman": post.cal_spearman().get("spearman_mean"),
           "protein_F1": post.cal_protein_classification().get("f1_F1macro")}
    print("imputation:", got["imputation"])
    print("marker spearman:", got["marker_spearman"])
    print("protein F1:", got["protein_F1"])
    got["figures"] = draw(post, post.plot_all,
                          os.path.join(out, f"tutorial_{model.id}"), figures)
    result[model.id] = got

  # --- 5. compare: the sheet's scores filtered by key, as pandas' .filter ----
  # (the sheet takes step 4's posteriors, whose scores are computed once)
  rs = ResultsSheet(*posteriors)
  scores = {name: {k: v for k, v in row.items() if "imputation" in k}
            for name, row in rs.get_scores().items()}
  for name, row in scores.items():
    print(name, row)
  result["sheet"] = scores
  result["sheet_figures"] = draw(rs, rs.plot_all,
                                 os.path.join(out, "tutorial_compare"),
                                 figures)
  return result


if __name__ == "__main__":
  run_cli(main, __doc__)

"""Uncertainty analysis: everything a VAE returns is a distribution. MC
posterior sampling, per-gene imputation uncertainty, the 4-way
corrupted/original log-likelihood and the importance-sampled marginal LLK
(port of ``tutorials/uncertainty_analysis.py``).

  python -m sisua_tpu_torch.tutorials.uncertainty_analysis
  python -m sisua_tpu_torch.tutorials.uncertainty_analysis --device cpu
"""

from __future__ import annotations

import os

from ._common import (at_depth, device_of, draw, first, host, out_dir_of,
                      run_cli)

SAMPLE_SHAPE = 10
MARGINAL_DRAWS = 50
EPOCHS = 15


def build(sco, device):
  from ..interpolation import linear
  from ..models import SCVI, RVmeta
  return SCVI(outputs=RVmeta(sco.n_vars, "zinbd", name="rna"),
              latents=RVmeta(10, "diag", name="latents"),
              beta=linear(vmin=0.0, vmax=1.0, norm=20), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import get_dataset
  from ..data.adapters import fit_sco, sco_matrices, sco_posterior
  dev, out = device_of(device), out_dir_of(out_dir, "uncertainty_analysis")
  draws = at_depth(SAMPLE_SHAPE, depth, least=2)

  # --- 1. train with KL warm-up ------------------------------------------------
  sco = get_dataset("synthetic")
  train, test = sco.split(0.8)
  model = build(sco, dev)
  fit_sco(model, train, valid=test, epochs=at_depth(EPOCHS, depth),
          batch_size=64, mc_samples=2, verbose=True)

  # --- 2. MC posterior predictive -------------------------------------------------
  pX, qZ = model.predict(sco_matrices(model, test), sample_shape=(draws,),
                         batch_size=128)
  means = host(first(pX).mean())               # (S, n_cells, n_genes)
  per_gene_std = means.std(axis=0)             # spread across the draws
  print("posterior-mean shape:", means.shape)
  print("mean per-gene imputation std:", float(per_gene_std.mean()))
  # latent uncertainty straight from the variational posterior
  latent_std = float(host(first(qZ).stddev()).mean())
  print("mean latent stddev:", latent_std)

  # --- 3. the Posterior's uncertainty metrics ---------------------------------------
  post = sco_posterior(model, test, sample_shape=draws)
  llk = post.cal_llk()          # 4-way: {imp,rec} × {original,corrupted}
  for k, v in sorted(llk.items()):
    print(f"  {k}: {v:.2f}")
  mllk = post.cal_marginal_llk(
      sample_shape=at_depth(MARGINAL_DRAWS, depth, least=2))
  print("importance-sampled marginal LLK:",
        {k: round(v, 2) for k, v in mllk.items()})

  # --- 4. the densest uncertainty view: imputed against observed -------------------
  n_fig = draw(post, post.plot_imputation_scatter,
               os.path.join(out, "tutorial_uncertainty"), figures)
  print("figures" if figures else "figure data", "in",
        os.path.join(out, "tutorial_uncertainty"))
  return {"posterior_mean_shape": list(means.shape),
          "mean_per_gene_std": float(per_gene_std.mean()),
          "mean_latent_stddev": latent_std, "llk": llk,
          "marginal_llk": mllk, "figures": n_fig}


if __name__ == "__main__":
  run_cli(main, __doc__)

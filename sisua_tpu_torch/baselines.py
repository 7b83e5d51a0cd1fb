"""Classical baselines: linear latent models and shallow predictors (the
port of ``sisua_tpu/baselines.py``).

PCA, probabilistic PCA (PCA with the full SVD), sparse PCA, NMF and
factor analysis latent spaces of the log counts, scored with the latent
benchmarks deep models are scored with (clustering against the cell
types, protein F1 of linear SVMs), so a fitted VAE can be compared with a
cheap baseline. The estimators are the port's sklearn counterparts
(``analysis/decomposition.py``), fitted on ``device`` (default
``'cuda'``, which must exist; ``'cpu'`` on request); sparse PCA's LARS
paths run on the host.

  python -m sisua_tpu_torch.baselines -ds synthetic -model pca,fa -zdim 10
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

__all__ = ["run_baseline", "BASELINE_MODELS", "main"]

BASELINE_MODELS = ("pca", "ppca", "sppca", "nmf", "fa")


def _fit_latent(x: np.ndarray, model: str, n_components: int, seed: int,
                device="cuda"):
  from .analysis.decomposition import PCA, NMF, FactorAnalysis, SparsePCA
  model = model.lower()
  if model == "pca":
    return PCA(n_components, random_state=seed, device=device).fit(x)
  if model == "ppca":  # probabilistic PCA = PCA with full ML noise model
    return PCA(n_components, svd_solver="full", random_state=seed,
               device=device).fit(x)
  if model == "sppca":  # sparse probabilistic PCA analogue
    return SparsePCA(n_components, random_state=seed, device=device).fit(x)
  if model == "nmf":
    return NMF(n_components, init="nndsvda", max_iter=400,
               random_state=seed, device=device).fit(np.maximum(x, 0))
  if model == "fa":
    return FactorAnalysis(n_components, random_state=seed,
                          device=device).fit(x)
  raise ValueError(f"unknown baseline '{model}'; options {BASELINE_MODELS}")


def run_baseline(sco,
                 model: str = "pca",
                 n_components: int = 10,
                 seed: int = 8,
                 verbose: bool = False,
                 device="cuda") -> Dict[str, float]:
  """Fit a linear latent baseline on the main omic of the port's
  ``SingleCellOMIC`` and score it with the standard latent benchmarks.
  Returns the score dict, keyed as the JAX function keys it."""
  from .analysis.latent import clustering_scores, streamline_classifier
  from .utils.others import UnitTimer

  x = np.log1p(sco.numpy())
  with UnitTimer(f"baseline:{model}", print_log=verbose):
    fitted = _fit_latent(x, model, n_components, seed, device)
    z = fitted.transform(x).cpu().numpy()
  scores: Dict[str, float] = {}
  # clustering vs celltype labels
  for cand in ("celltype", "disease", "progenitor"):
    if cand in sco.omics:
      labels = np.argmax(sco.numpy(cand), 1)
      scores.update({f"{k}_{cand}": v for k, v in clustering_scores(
          z, labels, device=device).items()})
      break
  # protein prediction F1
  if "proteomic" in sco.omics:
    _, _, ybin = sco.probabilistic_embedding("proteomic", device=device)
    n = len(z)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    cut = int(0.8 * n)
    _, test_f1 = streamline_classifier(
        z[idx[:cut]], ybin[idx[:cut]], z[idx[cut:]], ybin[idx[cut:]],
        sco.get_var_names("proteomic"), device=device)
    scores.update({f"f1_{k}": v for k, v in test_f1.items()})
  if verbose:
    print({k: round(v, 4) for k, v in scores.items()})
  return scores


def main(argv=None):
  p = argparse.ArgumentParser("sisua-baselines")
  p.add_argument("-ds", default="synthetic")
  p.add_argument("-model", default="pca",
                 help=f"comma-separated from {BASELINE_MODELS}")
  p.add_argument("-zdim", type=int, default=10)
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  from .data import get_dataset
  sco = get_dataset(args.ds)
  out = {}
  for m in args.model.split(","):
    out[m] = run_baseline(sco, m, n_components=args.zdim, verbose=True,
                          device=args.device)
  return out


if __name__ == "__main__":
  main()

"""Probabilistic embedding: protein (ADT) counts are continuous and noisy;
``ProbabilisticEmbedding`` fits a 2-component GMM per protein column and
binarizes at the positive component's CI threshold (port of
``tutorials/probabilistic_embedding.py``; ``sisua-embed`` wraps it).

  python -m sisua_tpu_torch.tutorials.probabilistic_embedding
  python -m sisua_tpu_torch.tutorials.probabilistic_embedding --device cpu
"""

from __future__ import annotations

import os

import numpy as np

from ._common import device_of, out_dir_of, run_cli


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import OMIC, get_dataset
  from ..label_threshold import ProbabilisticEmbedding
  dev, out = device_of(device), out_dir_of(out_dir,
                                           "probabilistic_embedding")

  # --- 1. protein counts ----------------------------------------------------
  sco = get_dataset("synthetic")
  y = sco.numpy(OMIC.proteomic)
  names = sco.get_var_names(OMIC.proteomic)
  print("proteins:", list(names), "| counts shape:", y.shape)

  # --- 2. fit per-column GMMs --------------------------------------------------
  pe = ProbabilisticEmbedding(device=dev).fit(y)
  y_bin = pe.predict(y)           # {0,1} per (cell, protein)
  y_prob = pe.predict_proba(y)    # positive-component responsibility
  rate = np.round(y_bin.mean(0), 3)
  print("positive rate per protein:", rate)
  if not (y_prob.min() >= 0 and y_prob.max() <= 1):
    raise AssertionError(f"probabilities outside [0, 1]: {y_prob.min()}, "
                         f"{y_prob.max()}")

  # --- 3. diagnostics (rendered only with figures: needs matplotlib) -----------
  if figures:
    path = os.path.join(out, "distributions.png")
    pe.plot_distribution(y, path=path)
    print("figures in", out)

  # --- 4. the same as a container method -----------------------------------------
  _, y_prob2, y_bin2 = sco.probabilistic_embedding(OMIC.proteomic,
                                                   device=dev)
  agrees = bool(np.allclose(y_bin, y_bin2))
  print("container call agrees:", agrees)
  return {"proteins": [str(n) for n in names], "counts_shape": list(y.shape),
          "positive_rate": rate.tolist(), "container_agrees": agrees}


if __name__ == "__main__":
  run_cli(main, __doc__)

"""Latent-space scores (port of ``sisua_tpu/analysis/latent.py``).

  * ``unsupervised_clustering_accuracy``: Hungarian-matched accuracy of
    cluster ids against labels (scipy's ``linear_sum_assignment``);
  * ``clustering_scores``: ASW, ARI, NMI and UCA averaged over KMeans and
    GaussianMixture partitions of the latents;
  * ``multi_label_adj_Rindex``: the ARI of each binary label column;
  * ``streamline_classifier``: per-protein F1 of one-vs-rest linear SVMs
    on latents against binarized protein labels.

The estimators are the port's own (``estimators``): they run on
``device`` (default 'cuda'; 'cpu' on request). The
plots and their 2-D embedding wait for the port's plotting layer.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .estimators import (GaussianMixture, KMeans, LinearSVC,
                         adjusted_rand_score, f1_score,
                         normalized_mutual_info_score, silhouette_score)

__all__ = ["unsupervised_clustering_accuracy", "clustering_scores",
           "multi_label_adj_Rindex", "streamline_classifier"]


def _host_int(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    a = a.detach().cpu().numpy()
  return np.asarray(a).ravel().astype(int)


def unsupervised_clustering_accuracy(y, y_pred
                                     ) -> Tuple[float, np.ndarray]:
  """Hungarian-matched clustering accuracy and the (cluster, label)
  assignment."""
  y, y_pred = _host_int(y), _host_int(y_pred)
  if len(y) != len(y_pred):
    raise ValueError(f"{len(y)} labels and {len(y_pred)} predictions")
  n = max(y.max(), y_pred.max()) + 1
  reward = np.zeros((n, n))
  np.add.at(reward, (y_pred, y), 1)
  row, col = linear_sum_assignment(-reward)
  acc = reward[row, col].sum() / len(y)
  return float(acc), np.stack([row, col], 1)


def multi_label_adj_Rindex(label_bin, y_pred, device="cuda") -> list:
  """ARI of each binary label column against ``y_pred``."""
  if label_bin.ndim != 2:
    raise ValueError(f"label_bin must be 2-D, got {label_bin.ndim}-D")
  return [float(adjusted_rand_score(label_bin[:, i], y_pred, device))
          for i in range(label_bin.shape[1])]


def clustering_scores(latent, labels, n_labels: Optional[int] = None,
                      prediction_algorithm: str = "both",
                      seed: int = 8, device="cuda") -> Dict[str, float]:
  """ASW/ARI/NMI/UCA of the latent clusters against ``labels`` (ids).

  KMeans (10 restarts) and a full GaussianMixture (``prediction_
  algorithm`` 'kmeans'/'knn', 'gmm' or 'both') run on ``device``; the
  silhouette is computed once over all cell pairs (0 when it is
  undefined)."""
  labels = _host_int(labels)
  n_labels = n_labels or int(labels.max() + 1)
  preds = []
  if prediction_algorithm in ("knn", "kmeans", "both"):
    preds.append(KMeans(n_labels, n_init=10, random_state=seed,
                        device=device).fit_predict(latent))
  if prediction_algorithm in ("gmm", "both"):
    preds.append(GaussianMixture(n_labels, random_state=seed,
                                 device=device).fit_predict(latent))
  try:
    asw = float(silhouette_score(latent, labels, device))
  except ValueError:
    asw = 0.0
  scores: Dict[str, list] = {"ASW": [asw], "ARI": [], "NMI": [], "UCA": []}
  for pred in preds:
    scores["ARI"].append(adjusted_rand_score(labels, pred, device))
    scores["NMI"].append(normalized_mutual_info_score(labels, pred,
                                                      device))
    scores["UCA"].append(unsupervised_clustering_accuracy(labels, pred)[0])
  return {k: float(np.mean(v)) for k, v in scores.items()}


def streamline_classifier(Z_train, y_train, Z_test, y_test,
                          labels_name: Sequence[str], mode: str = "ovr",
                          seed: int = 8, device="cuda"):
  """Per-protein F1 of one-vs-rest linear SVMs on latents.

  ``y_*`` are label matrices, binarized at 0.5; columns that hold one
  class in training are dropped. Returns ``(train_scores, test_scores)``,
  each {protein: F1, 'F1micro', 'F1macro'}, or two empty dicts when no
  column is left. The SVMs are fitted on ``device``. ``mode`` and
  ``seed`` are the JAX signature's: the JAX function fits one-vs-rest
  whatever ``mode`` says, and its ``seed`` orders liblinear's coordinate
  descent, which the port's exact Newton solve does not have."""
  def binary(y):
    if isinstance(y, torch.Tensor):
      y = y.detach().cpu().numpy()
    return (np.asarray(y) > 0.5).astype(int)
  y_train, y_test = binary(y_train), binary(y_test)
  valid = [i for i in range(y_train.shape[1])
           if len(np.unique(y_train[:, i])) == 2]
  if not valid:
    return {}, {}
  names = [str(labels_name[i]) for i in valid]
  clf = LinearSVC(device=device).fit(Z_train, y_train[:, valid])
  out = {}
  for split, Z, y in (("train", Z_train, y_train[:, valid]),
                      ("test", Z_test, y_test[:, valid])):
    pred = clf.predict(Z).cpu().numpy()
    per = {n: f1_score(y[:, i], pred[:, i], device=device)
           for i, n in enumerate(names)}
    per["F1micro"] = f1_score(y, pred, "micro", device)
    per["F1macro"] = f1_score(y, pred, "macro", device)
    out[split] = per
  return out["train"], out["test"]

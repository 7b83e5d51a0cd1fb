"""Latent-space scores (port of ``sisua_tpu/analysis/latent.py``).

  * ``unsupervised_clustering_accuracy``: Hungarian-matched accuracy of
    cluster ids against labels (scipy's ``linear_sum_assignment``);
  * ``clustering_scores``: ASW, ARI, NMI and UCA averaged over KMeans and
    GaussianMixture partitions of the latents;
  * ``multi_label_adj_Rindex``: the ARI of each binary label column;
  * ``streamline_classifier``: per-protein F1 of one-vs-rest linear SVMs
    on latents against binarized protein labels.

The estimators are the port's own (``estimators``): they run on
``device`` (default 'cuda'; 'cpu' on request). So do the plots' data
steps: the group centroids and their distances, the 2-D embedding (the
port's sklearn-following t-SNE, ``TSNE(2, init='pca', random_state=8)``
up to 8,000 cells, else ``PCA(2)``) and the protein contrasts; they draw
with matplotlib (``utils.visualization``).
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
           "multi_label_adj_Rindex", "streamline_classifier",
           "plot_distance_heatmap", "plot_latents_protein_pairs",
           "plot_latents_binary"]


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
                          seed: int = 8, return_figure: bool = False,
                          title: str = "", device="cuda"):
  """Per-protein F1 of one-vs-rest linear SVMs on latents.

  ``y_*`` are label matrices, binarized at 0.5; columns that hold one
  class in training are dropped. Returns ``(train_scores, test_scores)``,
  each {protein: F1, 'F1micro', 'F1macro'}, or two empty dicts when no
  column is left. With ``return_figure``, ``((train, test), figure)``:
  the per-protein F1 bars of the test decisions (None when no column is
  left). The SVMs are fitted on ``device``. ``mode`` and
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
    return (({}, {}), None) if return_figure else ({}, {})
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
  if return_figure:
    from ..utils.visualization import plot_evaluate_classifier
    _, fig = plot_evaluate_classifier(
        clf.decision_function(Z_test) > 0, y_test[:, valid], names,
        title=title or "latent→protein F1", return_figure=True,
        device=device)
    return (out["train"], out["test"]), fig
  return out["train"], out["test"]


# ---------------------------------------------------------------------------
# Plots: data steps on ``device``, render steps on matplotlib
# ---------------------------------------------------------------------------
def _on(a, device) -> torch.Tensor:
  from ..models.base import resolve_device
  t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
  return t.to(resolve_device(device))


def _distance_heatmap_data(Z, labels, device="cuda") -> dict:
  """The label groups' latent centroids (numpy's float32 order) and
  their Euclidean distances in float64."""
  from ..data.visualizer import _cdist, _group_mean
  z = _on(Z, device)
  labels = np.asarray(labels)
  uniq = np.unique(labels)
  cent = torch.stack([_group_mean(z[torch.as_tensor(
      np.where(labels == u)[0], device=z.device)]) for u in uniq])
  return dict(dm=_cdist(cent, "euclidean"), uniq=[str(u) for u in uniq])


def plot_distance_heatmap(Z, labels, title: str = "latent distance",
                          device="cuda"):
  from ..data.visualizer import _render_distance_heatmap
  return _render_distance_heatmap(title=title, **_distance_heatmap_data(
      Z, labels, device))


def _embed2d(Z, algo: str, device="cuda") -> np.ndarray:
  """The 2-D embedding the latent plots draw: the latents themselves at
  one or two dims, else t-SNE (up to 8,000 cells) or PCA."""
  z = _on(Z, device)
  if z.shape[1] == 1:  # the plots index emb[:, 1]: a zero column is added
    return torch.cat([z, torch.zeros_like(z)], 1).cpu().numpy()
  if z.shape[1] == 2:
    return z.cpu().numpy()
  if algo == "tsne" and z.shape[0] <= 8000:
    from .manifold import TSNE
    emb = TSNE(2, init="pca", random_state=8,
               device=z.device).fit_transform(z)
  else:
    from .decomposition import PCA
    emb = PCA(2, random_state=8, device=z.device).fit_transform(z)
  return emb.cpu().numpy()


def _protein_pairs_data(Z, y, labels_name, pairs=None, algo="tsne",
                        device="cuda") -> Optional[dict]:
  from ..data.const import PROTEIN_PAIR_NEGATIVE
  from ..data.utils import standardize_protein_name
  # knowledge-base pairs match the standardized protein names, explicit
  # pairs the raw names too
  name_idx = {}
  for i, n in enumerate(labels_name):
    name_idx.setdefault(standardize_protein_name(str(n)), i)
  for i, n in enumerate(labels_name):
    name_idx.setdefault(str(n), i)
  if pairs is None:
    pairs = [p for p in PROTEIN_PAIR_NEGATIVE
             if p[0] in name_idx and p[1] in name_idx][:6]
  if not pairs:
    return None
  emb = _embed2d(Z, algo, device)
  ly = torch.log1p(_on(y, device))
  contrast = torch.stack([ly[:, name_idx[a]] - ly[:, name_idx[b]]
                          for a, b in pairs], 1)
  return dict(emb=emb, contrast=contrast.cpu().numpy(),
              pairs=[(str(a), str(b)) for a, b in pairs])


def plot_latents_protein_pairs(Z, y, labels_name: Sequence[str],
                               pairs: Optional[Sequence[Tuple[str, str]]]
                               = None,
                               algo: str = "tsne",
                               title: str = "",
                               device="cuda"):
  """2-D latent embedding colored by the (pos, neg) protein-pair
  contrast; None when no pair is present."""
  d = _protein_pairs_data(Z, y, labels_name, pairs, algo, device)
  return None if d is None else _render_protein_pairs(title=title, **d)


def _render_protein_pairs(emb, contrast, pairs, title):
  from ..utils.visualization import _pyplot
  plt = _pyplot()
  ncol = min(3, len(pairs))
  nrow = int(np.ceil(len(pairs) / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3.5 * nrow),
                           squeeze=False)
  for k, (a, b) in enumerate(pairs):
    ax = axes[k // ncol][k % ncol]
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=contrast[:, k], s=6,
                    cmap="coolwarm", linewidths=0)
    ax.set_title(f"{a} vs {b}", fontsize=8)
    ax.set_xticks([]); ax.set_yticks([])
    fig.colorbar(sc, ax=ax)
  fig.suptitle(title)
  fig.tight_layout()
  return fig


def _latents_binary_data(Z, y_bin, labels_name, algo="tsne",
                         device="cuda") -> dict:
  emb = _embed2d(Z, algo, device)
  names = np.asarray([str(n) for n in labels_name])
  y_bin = y_bin.cpu().numpy() if isinstance(y_bin, torch.Tensor) \
      else np.asarray(y_bin)
  lab = np.asarray(["+".join(names[row > 0.5]) or "none" for row in y_bin])
  # rare combinations collapse to 'other'
  uniq, counts = np.unique(lab, return_counts=True)
  keep = set(uniq[np.argsort(-counts)][:12])
  lab = np.asarray([l if l in keep else "other" for l in lab])
  return dict(emb=emb[:, :2], labels=lab)


def plot_latents_binary(Z, y_bin, labels_name: Sequence[str],
                        algo: str = "tsne", title: str = "",
                        device="cuda"):
  """Latent embedding colored by the combination of positive
  proteins."""
  return _render_latents_binary(title=title, **_latents_binary_data(
      Z, y_bin, labels_name, algo, device))


def _render_latents_binary(emb, labels, title):
  from ..utils.visualization import fast_scatter
  return fast_scatter(emb, labels=labels, title=title).get_figure()

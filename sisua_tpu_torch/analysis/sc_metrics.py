"""Training-time metric callbacks, scored every ``freq`` epochs (port of
``sisua_tpu/analysis/sc_metrics.py``).

``SingleCellMetric`` corrupts the main matrix of its evaluation data once
(``data.utils.apply_artificial_corruption``, seed 8, as the JAX package's
``SingleCellOMIC.corrupt``), serves the model on the corrupted data every
``freq`` epochs with ``sample_shape`` MC draws, and writes the scores of
``call`` into the epoch's logs as ``f"{name}_{key}"``. The port takes
arrays in place of the JAX package's ``sco``: ``data=[x, y, …]``, the
true matrices of the model's outputs in order (numpy, scipy or tensors),
and ``var_names=[genes, proteins]`` for ``CorrelationScores``.

Unlike the JAX callbacks, no distribution goes to the host: each served
batch is reduced on the device to what its score needs (``_reduce``), and
only that is kept: (n,) log-likelihoods, the (n, D) imputed mean, the
imputed marker columns, the latent means. ``call(y_true, pX, qZ)`` scores
whole distributions, the JAX surface. ``ClusteringScores`` takes its cell
labels as an array (``labels=``) in place of the JAX lookup of a label
omic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.utils import apply_artificial_corruption
from ..models.base import _as_device_matrix, _flatten
from ..models.objective import mc_row_log_prob
from ..train.trainer import TrainingCallback
from .imputation import (_marker_pairs, correlation_scores,
                         imputation_mean_score, imputation_score)
from .latent import clustering_scores
from .posterior import _dist_mean, _unwrap_imputed

__all__ = ["SingleCellMetric", "NegativeLogLikelihood", "ImputationError",
           "CorrelationScores", "ClusteringScores"]


def _host(a):
  """A matrix as the host array the corruption routine takes."""
  if isinstance(a, torch.Tensor):
    return a.detach().cpu().numpy()
  return a


def _rows(y: torch.Tensor, lo: int, nv: int, b: int) -> torch.Tensor:
  """Rows ``lo``…``lo + nv`` of ``y``, zero-padded to ``b`` rows (a served
  batch's padding)."""
  out = y[lo:lo + nv]
  if nv < b:
    out = torch.cat([out, out.new_zeros((b - nv,) + tuple(out.shape[1:]))])
  return out


class SingleCellMetric(TrainingCallback):
  """Base callback: corrupt once, serve every ``freq`` epochs, score.

  Subclasses give ``_reduce(y_true, pX, qZ)``, a served batch's score
  inputs as tensors with the cells first, and ``_score(parts, y_true)``,
  the scores of the whole set from the concatenated inputs."""

  def __init__(self, data=None, var_names: Optional[Sequence] = None,
               freq: int = 3, dropout_rate: float = 0.2,
               retain_rate: float = 0.2, sample_shape: int = 2,
               batch_size: int = 256, name: Optional[str] = None,
               verbose: bool = False):
    self.data = None if data is None else list(_flatten(data))
    self.var_names = var_names
    self.freq = int(freq)
    self.dropout_rate = float(dropout_rate)
    self.retain_rate = float(retain_rate)
    self.sample_shape = int(sample_shape)
    self.batch_size = int(batch_size)
    self.verbose = verbose
    self._name = name or type(self).__name__
    self._corrupted = None
    self._on_device = {}

  @property
  def name(self):
    return self._name

  def _prepare(self) -> List:
    """The evaluation data with its main matrix corrupted (host arrays;
    the other matrices as given)."""
    if self._corrupted is None:
      main = apply_artificial_corruption(
          _host(self.data[0]), dropout=self.dropout_rate,
          retain_rate=self.retain_rate, copy=True)
      self._corrupted = [main] + self.data[1:]
    return self._corrupted

  def _device(self, key: str, a, dev: torch.device) -> torch.Tensor:
    """``a`` as a float32 tensor on ``dev``, uploaded once."""
    t = self._on_device.get(key)
    if t is None or t.device != dev:
      t = self._on_device[key] = _as_device_matrix(a, dev)
    return t

  def _targets(self, dev: torch.device) -> List[torch.Tensor]:
    return [self._device(f"true{i}", a, dev)
            for i, a in enumerate(self.data[:self.model.n_outputs])]

  def _reduce(self, y_true, pX, qZ) -> List[torch.Tensor]:
    raise NotImplementedError

  def _score(self, parts: List[torch.Tensor], y_true) -> Dict[str, float]:
    raise NotImplementedError

  def call(self, y_true, pX, qZ) -> Dict[str, float]:
    """The scores of whole distributions: ``y_true`` the true matrices of
    the outputs, ``pX``/``qZ`` the outputs' and latents' distributions."""
    return self._score(self._reduce(y_true, pX, qZ), y_true)

  def on_epoch_end(self, epoch: int, logs: Dict):
    if self.data is None or (epoch % self.freq) != 0:
      return
    y_true = self._targets(self.model.device)
    batches = []
    with torch.no_grad():
      for out, lo, nv in self.model._served_batches(
          self._prepare(), (self.sample_shape,), self.batch_size):
        b = out.outputs[0].batch_shape[-1]
        yb = [_rows(y, lo, nv, b) for y in y_true]
        batches.append([r[:nv] for r in self._reduce(yb, out.outputs,
                                                     out.latents)])
    scores = self._score([torch.cat(p) for p in zip(*batches)], y_true)
    for k, v in scores.items():
      logs[f"{self.name}_{k}" if k else self.name] = float(v)
    if self.verbose:
      print(f"[{self.name}] epoch {epoch}:",
            {k: round(float(v), 4) for k, v in scores.items()})


def _first(x):
  return x[0] if isinstance(x, (tuple, list)) else x


def _as_tensor(y) -> torch.Tensor:
  """A tensor as it is; an array as a float32 CPU tensor (``call`` on host
  distributions)."""
  if isinstance(y, torch.Tensor):
    return y
  return torch.as_tensor(np.asarray(y, np.float32))


class NegativeLogLikelihood(SingleCellMetric):
  """−log p(x_true | x_corrupted) per output: the MC draws' log-likelihoods
  as logsumexp − log S, averaged over cells (keys ``nllk``, ``nllk1``,
  …). A ZINB/NB output's draws go through the fused forward, one launch
  for all draws (``models.objective.mc_row_log_prob``)."""

  def _reduce(self, y_true, pX, qZ):
    parts = []
    for x, dist in zip(y_true, _flatten(pX)):
      lp = mc_row_log_prob(dist, _as_tensor(x))
      if lp.ndim > 1:
        lp = torch.logsumexp(lp, 0) - math.log(lp.shape[0])
      parts.append(lp)
    return parts

  def _score(self, parts, y_true):
    out = {}
    for i, lp in enumerate(parts):
      lp = lp.cpu().numpy()  # (n,): the one fetch
      out[f"nllk{i}" if i else "nllk"] = -float(lp.mean())
    return out


class ImputationError(SingleCellMetric):
  """Median and mean imputation error of the main output against its
  uncorrupted counts (keys ``med``, ``mean``), scored where the imputed
  mean lies; ``imputed`` keeps the last (n, D) imputed mean, fetched."""

  imputed: Optional[np.ndarray] = None

  def _reduce(self, y_true, pX, qZ):
    return [_dist_mean(_unwrap_imputed(_first(pX)))]

  def _score(self, parts, y_true):
    imp = parts[0]
    cor = self._device("corrupted", self._prepare()[0], imp.device)
    org = y_true[0]
    scores = {"med": imputation_score(org, imp),
              "mean": imputation_mean_score(org, cor, imp)}
    self.imputed = imp.cpu().numpy()
    return scores


class CorrelationScores(SingleCellMetric):
  """Spearman and Pearson between the imputed marker genes and their
  proteins, averaged over the marker pairs (keys ``spearman``,
  ``pearson``; none when no pair is found). Needs ``data=[rna, adt, …]``
  and ``var_names=[genes, proteins]``; only the marker columns of the
  imputed mean are kept."""

  _cols: Optional[List[int]] = None

  def _columns(self) -> List[int]:
    """The imputed matrix's marker columns."""
    if (self.var_names is None or len(self.var_names) < 2
        or len(self.data) < 2):
      raise ValueError("CorrelationScores requires data=[rna, adt] and "
                       "var_names=[genes, proteins]")
    if self._cols is None:
      self._cols = sorted({p[2] for p in
                           _marker_pairs(*self.var_names[:2])})
    return self._cols

  def _reduce(self, y_true, pX, qZ):
    imp = _dist_mean(_unwrap_imputed(_first(pX)))
    return [imp[:, torch.as_tensor(self._columns(), device=imp.device)]]

  def _score(self, parts, y_true):
    cols = self._columns()
    if not cols:
      return {}
    genes = [str(self.var_names[0][c]) for c in cols]
    corr = correlation_scores(parts[0], self.data[1], genes,
                              self.var_names[1])
    return {"spearman": float(np.mean([v[0] for v in corr.values()])),
            "pearson": float(np.mean([v[1] for v in corr.values()]))}


class ClusteringScores(SingleCellMetric):
  """ASW, ARI, NMI and UCA of the latent means against cell labels
  (``clustering_scores``; keys ``ASW``, ``ARI``, ``NMI``, ``UCA``). The
  port takes ``labels=``, one id per cell of ``data`` or a one-hot (or
  score) matrix whose row argmax is the id, in place of the JAX package's
  lookup of a 'celltype', 'disease' or 'progenitor' omic; without labels
  there is nothing to score. Only the latent means are kept from each
  served batch, and the estimators run where they lie."""

  def __init__(self, labels=None, **kwargs):
    super().__init__(**kwargs)
    self.labels = labels

  def _reduce(self, y_true, pX, qZ):
    return [_first(qZ).mean()]

  def _score(self, parts, y_true):
    if self.labels is None:
      return {}
    labels = np.asarray(_host(self.labels))
    if labels.ndim == 2:
      labels = np.argmax(labels, 1)
    return clustering_scores(parts[0], labels, device=parts[0].device)

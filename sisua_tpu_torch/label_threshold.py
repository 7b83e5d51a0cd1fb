"""ProbabilisticEmbedding: GMM probabilization of protein counts (port of
``sisua_tpu/label_threshold.py``).

Per protein column: (1) normalize: drop the zeros but one (kept as an
anchor), optionally IQR-clip, log-norm ``log1p(x / sum · 1e4)`` in
float32, on the host in numpy's arithmetic; (2) fit a 2-component
diagonal GaussianMixture (8 inits, 120 EM iterations; a mean threshold
when the column is degenerate), the port's own (``analysis.estimators``)
on ``device`` (default 'cuda'; 'cpu' on request); (3) ``predict`` binarizes at
the lower bound of the ``|ci_threshold|`` normal confidence interval of
the positive (higher-mean) component (``scipy.stats.norm.interval``),
``predict_proba`` averages the positive components' responsibilities.
Outputs are numpy arrays, as in the JAX package.

The ``sisua-embed`` CLI (``main``) waits for the port's CLIs (ROADMAP
A22), the plots for its plotting layer.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import stats

from .analysis.estimators import GaussianMixture

__all__ = ["ProbabilisticEmbedding"]


def _clipping_quartile(x: np.ndarray, alpha: float = 1.5,
                       test_mode: bool = False) -> np.ndarray:
  x = x.astype("float32")
  q1, q3 = np.percentile(x, 25), np.percentile(x, 75)
  iqr = q3 - q1
  low, high = q1 - alpha * iqr, q3 + alpha * iqr
  if test_mode:  # clamp (keeps alignment with the input rows)
    x = np.clip(x, low, high)
  else:  # drop (training-time)
    x = x[(low <= x) & (x <= high)]
  return x


def _log_norm(x: np.ndarray, scale_factor: float = 1e4) -> np.ndarray:
  x = x.astype("float32")
  s = np.sum(x)
  return np.log1p(x / (s + np.finfo(np.float32).eps) * scale_factor)


class _DummyGMM:
  """Mean-threshold fallback for a degenerate column."""

  def __init__(self):
    self.means_ = None
    self.precisions_ = None

  def fit(self, X):
    self.means_ = np.array([np.mean(X)])
    self.precisions_ = np.array([1.0 / max(np.var(X), 1e-12)])
    return self

  def predict(self, X):
    return (X >= self.means_[0]).astype(np.float32).ravel()

  def predict_proba(self, X):
    return self.predict(X)


def _host(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    return a.detach().cpu().numpy()
  return np.asarray(a)


class ProbabilisticEmbedding:
  """Per-feature GMM thresholding: binary and probabilistic labels."""

  def __init__(self,
               n_components_per_class: int = 2,
               positive_component: int = 1,
               log_norm: bool = True,
               clip_quartile: float = 0.0,
               remove_zeros: bool = True,
               ci_threshold: float = -0.68,
               random_state: int = 8,
               verbose: bool = False,
               device="cuda"):
    if positive_component <= 0:
      raise ValueError("positive_component must be > 0")
    if not 0.0 <= abs(ci_threshold) <= 1.0:
      raise ValueError("|ci_threshold| must be in [0, 1]")
    self.n_components_per_class = int(n_components_per_class)
    self.positive_component = int(positive_component)
    self.log_norm = bool(log_norm)
    self.clip_quartile = float(clip_quartile)
    self.remove_zeros = bool(remove_zeros)
    self.ci_threshold = float(ci_threshold)
    self.random_state = random_state
    self.verbose = bool(verbose)
    self.device = device
    self._models: List[Tuple[np.ndarray, object]] = []

  # ------------------------------------------------------------------ props
  @property
  def n_classes(self) -> int:
    return len(self._models)

  @staticmethod
  def _stack_ragged(cols: List[np.ndarray]) -> np.ndarray:
    """hstack per-feature component columns, NaN-padding features whose
    fit fell back to the 1-component ``_DummyGMM``."""
    k = max(c.shape[0] for c in cols)
    cols = [np.pad(c, ((0, k - c.shape[0]), (0, 0)),
                   constant_values=np.nan) for c in cols]
    return np.hstack(cols)

  @staticmethod
  def _param(gmm, name: str) -> np.ndarray:
    return _host(getattr(gmm, name)).ravel()

  @property
  def means(self) -> np.ndarray:
    return self._stack_ragged([self._param(gmm, "means_")[order][:, None]
                               for order, gmm in self._models])

  @property
  def precisions(self) -> np.ndarray:
    return self._stack_ragged([self._param(gmm, "precisions_")[order][:, None]
                               for order, gmm in self._models])

  # ------------------------------------------------------------------- core
  def normalize(self, x: np.ndarray, test_mode: bool = False) -> np.ndarray:
    x = _host(x)
    if x.ndim > 1:
      x = x.ravel()
    n = len(x)
    if not np.all(x >= 0):
      raise ValueError("Only support non-negative values")
    if self.remove_zeros and not test_mode:
      x = x[x > 0]
      if len(x) != n:  # keep a single zero as anchor
        x = np.concatenate([[0], x], axis=0)
    if self.clip_quartile > 0:
      x = _clipping_quartile(x, alpha=self.clip_quartile, test_mode=test_mode)
    if self.log_norm:
      x = _log_norm(x)
    return x

  def fit(self, X) -> "ProbabilisticEmbedding":
    """One GMM per column of X (numpy or a tensor), fitted on
    ``device``."""
    X = _host(X)
    if X.ndim != 2:
      raise ValueError(f"Expect a matrix, given: {X.shape}")
    self._models = []
    for i in range(X.shape[1]):
      x_train = self.normalize(X[:, i], test_mode=False)
      try:
        if len(x_train) < 2 * self.n_components_per_class:
          raise ValueError("too few samples for a GMM fit")
        gmm = GaussianMixture(n_components=self.n_components_per_class,
                              covariance_type="diag", n_init=8, max_iter=120,
                              random_state=self.random_state,
                              device=self.device)
        gmm.fit(x_train[:, None])
      except ValueError:
        # a degenerate column (all zeros: one anchor sample; constant
        # values: an ill-defined covariance) → the mean threshold
        gmm = _DummyGMM().fit(x_train[:, None])
      order = np.argsort(self._param(gmm, "means_"))
      self._models.append((order, gmm))
    return self

  def fit_transform(self, X, return_probabilities: bool = True) -> np.ndarray:
    self.fit(X)
    return self.predict_proba(X) if return_probabilities else self.predict(X)

  def _predict(self, X, threshold: Optional[float]) -> np.ndarray:
    X = _host(X)
    if X.shape[1] != self.n_classes:
      raise ValueError(f"{X.shape[1]} columns for {self.n_classes} fitted "
                       "features")
    cols = []
    for i, (order, gmm) in enumerate(self._models):
      x_test = self.normalize(X[:, i], test_mode=True)
      if isinstance(gmm, _DummyGMM):
        out = gmm.predict(x_test)
      elif threshold is not None:
        pos = order[self.positive_component]
        ci = stats.norm.interval(
            abs(threshold),
            loc=self._param(gmm, "means_")[pos],
            scale=np.sqrt(1.0 / self._param(gmm, "precisions_")[pos]))
        cut = ci[0] if threshold < 0 else ci[1]
        out = (x_test >= cut).astype("float32")
      else:
        dev = gmm.means_.device
        probas = _host(gmm.predict_proba(
            torch.as_tensor(x_test[:, None], device=dev))).T[order]
        out = np.mean(probas[self.positive_component:], axis=0)
      cols.append(out[:, None])
    return np.concatenate(cols, axis=1)

  def predict(self, X) -> np.ndarray:
    """Binary labels via CI thresholding."""
    return self._predict(X, threshold=self.ci_threshold)

  def predict_proba(self, X) -> np.ndarray:
    """Probabilistic labels: positive-component responsibilities."""
    return self._predict(X, threshold=None)

  def score_samples(self, X) -> np.ndarray:
    scores = []
    for x, (order, gmm) in zip(_host(X).T, self._models):
      x = self.normalize(x, test_mode=True)
      if isinstance(gmm, _DummyGMM):
        s = -0.5 * (x - gmm.means_[0]) ** 2 * gmm.precisions_[0]
      else:
        s = _host(gmm.score_samples(
            torch.as_tensor(x[:, None], device=gmm.means_.device)))
      scores.append(np.asarray(s).ravel()[:, None])
    return np.mean(np.hstack(scores), axis=1)

  def score(self, X, y=None) -> float:
    return float(self.score_samples(X).mean())

  # -------------------------------------------------------------------- io
  def save(self, path: str):
    with open(path, "wb") as f:
      pickle.dump(self, f)

  @staticmethod
  def load(path: str) -> "ProbabilisticEmbedding":
    """Unpickle a saved embedding (only files this package wrote)."""
    with open(path, "rb") as f:
      return pickle.load(f)

"""Criticizer: disentanglement metrics over (latents, factors) (port of
``sisua_tpu/analysis/criticizer.py``).

The nine scores of the JAX ``Criticizer`` (``cal_clustering_scores``,
``cal_dci_scores``, ``cal_mutual_info_gap``, ``cal_total_correlation``,
``cal_separated_attr_predictability``, ``cal_relative_disentanglement_
strength``, ``cal_relative_mutual_strength``, ``cal_betavae_score``,
``cal_factorvae_score``) and its three matrices, on the port's own
estimators (``estimators``) in place of sklearn:

  * BetaVAE (Higgins et al. 2017): logistic regression on |z₁ − z₂| of
    latent pairs sharing one factor value;
  * FactorVAE (Kim & Mnih 2018): majority vote on the argmin of the
    per-dimension variance of normalized latents with one factor fixed;
  * MIG (Chen et al. 2018), SAP (Kumar et al. 2018) and the relative
    strengths, on the discrete mutual-information matrix;
  * DCI (Eastwood & Williams 2018): importances of gradient-boosted trees;
  * the Gaussian total correlation of the latents.

The random draws are the JAX package's: ``RandomState(seed)`` for the DCI
split, ``seed + 1`` for BetaVAE and ``seed + 2`` for FactorVAE, so the same
rows are drawn. The clustering scores and the BetaVAE classifier run on
``device`` (default 'cuda'; 'cpu' on request); the small matrices (the rank
correlation, the discrete MI of the codes, the boosted trees, the
log-determinant) are computed on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import stats as sp_stats

from .estimators import (GradientBoostingClassifier, LogisticRegression,
                         _resolve, mutual_info_score)
from .latent import clustering_scores

__all__ = ["Criticizer", "discretize_factors"]


def discretize_factors(factors, n_bins: int = 5) -> np.ndarray:
  """Quantile-bin continuous factor columns into integer codes; a column
  with at most ``n_bins`` distinct values keeps one code per value."""
  factors = np.asarray(factors)
  out = np.zeros(factors.shape, np.int32)
  for j in range(factors.shape[1]):
    col = factors[:, j]
    uniq = np.unique(col)
    if len(uniq) <= n_bins:
      out[:, j] = np.searchsorted(uniq, col)
    else:
      qs = np.quantile(col, np.linspace(0, 1, n_bins + 1)[1:-1])
      out[:, j] = np.digitize(col, qs)
  return out


def _discrete_mutual_info(z_binned: np.ndarray, f_codes: np.ndarray
                          ) -> np.ndarray:
  """(n_latents, n_factors) MI matrix between binned latents and factors."""
  z = torch.as_tensor(z_binned)
  f = torch.as_tensor(f_codes)
  mi = np.zeros((z.shape[1], f.shape[1]))
  for i in range(z.shape[1]):
    for j in range(f.shape[1]):
      mi[i, j] = mutual_info_score(z[:, i], f[:, j], device="cpu")
  return mi


def _entropy(codes: np.ndarray) -> np.ndarray:
  out = np.zeros(codes.shape[1])
  for j in range(codes.shape[1]):
    _, cnt = np.unique(codes[:, j], return_counts=True)
    p = cnt / cnt.sum()
    out[j] = -np.sum(p * np.log(p + 1e-12))
  return out


class Criticizer:
  """Holds (latents, factors) and computes the metric suite.

  ``latents``: (n_cells, n_latents) representation means, numpy or a
  tensor; the clustering and BetaVAE estimators run on ``device``.
  ``factors``: (n_cells, n_factors) ground-truth factors (counts, one-hot
  or continuous; discretized internally)."""

  def __init__(self,
               latents,
               factors,
               factor_names: Optional[Sequence[str]] = None,
               n_bins: int = 5,
               seed: int = 8,
               device="cuda"):
    self.device = _resolve(device)
    if isinstance(latents, torch.Tensor):
      latents = latents.detach().cpu().numpy()
    if isinstance(factors, torch.Tensor):
      factors = factors.detach().cpu().numpy()
    self.latents = np.asarray(latents, np.float64)
    self.factors = np.asarray(factors, np.float64)
    if self.latents.shape[0] != self.factors.shape[0]:
      raise ValueError(f"{self.latents.shape[0]} latent rows and "
                       f"{self.factors.shape[0]} factor rows")
    self.factor_names = list(factor_names) if factor_names is not None else \
        [f"factor{i}" for i in range(self.factors.shape[1])]
    self.n_bins = int(n_bins)
    self.seed = int(seed)
    self.factor_codes = discretize_factors(self.factors, n_bins)
    self.latent_codes = discretize_factors(self.latents, max(n_bins, 10))
    self._rng = np.random.RandomState(seed)
    self._cache: Dict[object, object] = {}

  def _on_device(self, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=self.device)

  # ------------------------------------------------------------- matrices
  def create_correlation_matrix(self, method: str = "spearman"
                                ) -> np.ndarray:
    """(n_latents, n_factors) correlation matrix ('spearman': of the
    average ranks; else Pearson)."""
    key = f"corr_{method}"
    if key in self._cache:
      return self._cache[key]
    z, f = self.latents, self.factors
    if method == "spearman":
      z = np.apply_along_axis(sp_stats.rankdata, 0, z)
      f = np.apply_along_axis(sp_stats.rankdata, 0, f)
    zc = (z - z.mean(0)) / (z.std(0) + 1e-12)
    fc = (f - f.mean(0)) / (f.std(0) + 1e-12)
    m = (zc.T @ fc) / len(z)
    self._cache[key] = m
    return m

  def create_mutualinfo_matrix(self) -> np.ndarray:
    if "mi" not in self._cache:
      self._cache["mi"] = _discrete_mutual_info(self.latent_codes,
                                                self.factor_codes)
    return self._cache["mi"]

  def create_importance_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
    """(importance matrix, per-factor test accuracy) of gradient-boosted
    trees on an 80/20 split (the DCI protocol)."""
    if "imp" in self._cache:
      return self._cache["imp"]
    n = len(self.latents)
    idx = self._rng.permutation(n)
    cut = int(0.8 * n)
    tr, te = idx[:cut], idx[cut:]
    d, k = self.latents.shape[1], self.factor_codes.shape[1]
    imp = np.zeros((d, k))
    acc = np.zeros(k)
    for j in range(k):
      y = self.factor_codes[:, j]
      if len(np.unique(y[tr])) < 2:
        continue
      clf = GradientBoostingClassifier(n_estimators=30, max_depth=3,
                                       random_state=self.seed)
      clf.fit(self.latents[tr], y[tr])
      imp[:, j] = clf.feature_importances_
      acc[j] = clf.score(self.latents[te], y[te])
    self._cache["imp"] = (imp, acc)
    return imp, acc

  # --------------------------------------------------------------- metrics
  def cal_mutual_info_gap(self) -> Dict[str, float]:
    mi = self.create_mutualinfo_matrix()
    h = _entropy(self.factor_codes)
    gaps = []
    for j in range(mi.shape[1]):
      if h[j] <= 0:
        continue
      top2 = np.sort(mi[:, j])[-2:]
      gap = top2[-1] - (top2[0] if len(top2) > 1 else 0.0)
      gaps.append(gap / h[j])
    return {"mig": float(np.mean(gaps)) if gaps else 0.0}

  def cal_dci_scores(self) -> Dict[str, float]:
    imp, acc = self.create_importance_matrix()
    eps = 1e-11

    # normalized entropy; a 1-outcome distribution has entropy 0
    def _norm_entropy(p, axis, n):
      ent = -np.sum(p * np.log(p + eps), axis)
      return ent / np.log(n) if n > 1 else np.zeros_like(ent)
    p_d = imp / (imp.sum(1, keepdims=True) + eps)
    ent_d = _norm_entropy(p_d, 1, imp.shape[1])
    rel = imp.sum(1) / (imp.sum() + eps)
    disent = float(np.sum(rel * (1.0 - ent_d)))
    p_c = imp / (imp.sum(0, keepdims=True) + eps)
    ent_c = _norm_entropy(p_c, 0, imp.shape[0])
    complete = float(np.mean(1.0 - ent_c))
    return {"disentanglement": disent, "completeness": complete,
            "informativeness": float(np.mean(acc)), "dci": float(
                np.mean([disent, complete, np.mean(acc)]))}

  def cal_total_correlation(self) -> Dict[str, float]:
    """Gaussian TC of the latent representation: ½(Σ log σ²ᵢ − log|Σ|)."""
    z = self.latents - self.latents.mean(0)
    cov = (z.T @ z) / (len(z) - 1) + 1e-8 * np.eye(z.shape[1])
    _, logdet = np.linalg.slogdet(cov)
    tc = 0.5 * (np.sum(np.log(np.diag(cov))) - logdet)
    return {"tc": float(max(tc, 0.0))}

  def cal_separated_attr_predictability(self) -> Dict[str, float]:
    """SAP on the discrete MI matrix: mean over factors of the gap between
    the two most predictive latents."""
    score = self.create_mutualinfo_matrix()
    gaps = []
    for j in range(score.shape[1]):
      top2 = np.sort(score[:, j])[-2:]
      gaps.append(top2[-1] - (top2[0] if len(top2) > 1 else 0.0))
    return {"sap": float(np.mean(gaps))}

  def cal_betavae_score(self, n_samples: int = 2000, batch_size: int = 16
                        ) -> Dict[str, float]:
    """Higgins' metric on observational data: for a drawn factor j, pair
    cells sharing j's code, average |z₁ − z₂| over a batch, and classify j
    from it (80% train, 20% test)."""
    cache_key = ("betavae", n_samples, batch_size)
    if cache_key in self._cache:
      return self._cache[cache_key]
    rng = np.random.RandomState(self.seed + 1)
    X, y = self._interventional_features(n_samples, batch_size, rng=rng)
    cut = int(0.8 * len(X))
    if len(X) == 0 or cut == 0:
      out = {"betavae": 0.0}
    elif len(np.unique(y[:cut])) < 2:
      # one class in training: a majority vote is what the classifier
      # would converge to
      maj = np.bincount(y[:cut].astype(int)).argmax()
      te = y[cut:] if len(y) > cut else y[:cut]
      out = {"betavae": float(np.mean(te == maj))}
    else:
      clf = LogisticRegression(device=self.device)
      clf.fit(self._on_device(X[:cut]), torch.as_tensor(
          y[:cut], device=self.device))
      Xte, yte = (X[cut:], y[cut:]) if len(X) > cut else (X[:cut], y[:cut])
      out = {"betavae": clf.score(self._on_device(Xte),
                                  torch.as_tensor(yte, device=self.device))}
    self._cache[cache_key] = out
    return out

  def cal_factorvae_score(self, n_samples: int = 2000, batch_size: int = 16
                          ) -> Dict[str, float]:
    """Kim & Mnih's majority vote: the argmin of the per-dimension variance
    of normalized latents within a fixed-factor batch votes for the
    factor."""
    cache_key = ("factorvae", n_samples, batch_size)
    if cache_key in self._cache:
      return self._cache[cache_key]
    rng = np.random.RandomState(self.seed + 2)
    z_std = self.latents.std(0) + 1e-12
    votes = np.zeros((self.latents.shape[1], self.factor_codes.shape[1]))
    samples = []
    k = self.factor_codes.shape[1]
    for _ in range(n_samples):
      j = rng.randint(k)
      rows = self._rows_sharing_factor(j, batch_size, rng)
      if rows is None:
        continue
      zb = self.latents[rows] / z_std
      samples.append((int(np.argmin(zb.var(0))), j))
    if not samples:
      self._cache[cache_key] = {"factorvae": 0.0}
      return self._cache[cache_key]
    cut = int(0.8 * len(samples))
    for dim, j in samples[:cut]:
      votes[dim, j] += 1
    classifier = votes.argmax(1)
    correct = sum(int(classifier[dim] == j) for dim, j in samples[cut:])
    out = {"factorvae": correct / max(1, len(samples) - cut)}
    self._cache[cache_key] = out
    return out

  def cal_relative_disentanglement_strength(self) -> Dict[str, float]:
    """Mean over factors of (top1 − top2)/top1 of the |Spearman|
    matrix."""
    m = np.abs(self.create_correlation_matrix("spearman"))
    return {"rds": self._relative_strength(m)}

  def cal_relative_mutual_strength(self) -> Dict[str, float]:
    return {"rms": self._relative_strength(self.create_mutualinfo_matrix())}

  @staticmethod
  def _relative_strength(m: np.ndarray) -> float:
    vals = []
    for j in range(m.shape[1]):
      top2 = np.sort(m[:, j])[-2:]
      second = top2[0] if len(top2) > 1 else 0.0
      if top2[-1] > 0:
        vals.append((top2[-1] - second) / top2[-1])
    return float(np.mean(vals)) if vals else 0.0

  def cal_clustering_scores(self) -> Dict[str, float]:
    """``clustering_scores`` of the latents against the dominant factor
    (the factor codes' first column for one factor)."""
    if "clustering" not in self._cache:
      labels = np.argmax(self.factors, 1) if self.factors.shape[1] > 1 else \
          self.factor_codes[:, 0]
      self._cache["clustering"] = clustering_scores(
          self._on_device(self.latents), labels, seed=self.seed,
          device=self.device)
    return self._cache["clustering"]

  def cal_all_scores(self) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for fn in (self.cal_clustering_scores, self.cal_dci_scores,
               self.cal_mutual_info_gap, self.cal_total_correlation,
               self.cal_separated_attr_predictability,
               self.cal_relative_disentanglement_strength,
               self.cal_relative_mutual_strength, self.cal_betavae_score,
               self.cal_factorvae_score):
      out.update(fn())
    return out

  # ---------------------------------------------------------------- helpers
  def _rows_sharing_factor(self, j: int, batch_size: int,
                           rng: Optional[np.random.RandomState] = None
                           ) -> Optional[np.ndarray]:
    rng = rng if rng is not None else self._rng
    codes = self.factor_codes[:, j]
    val = codes[rng.randint(len(codes))]
    pool = np.nonzero(codes == val)[0]
    if len(pool) < 2:
      return None
    return rng.choice(pool, size=min(batch_size, len(pool)),
                      replace=len(pool) < batch_size)

  def _interventional_features(self, n_samples: int, batch_size: int,
                               rng: Optional[np.random.RandomState] = None):
    rng = rng if rng is not None else self._rng
    X, y = [], []
    k = self.factor_codes.shape[1]
    for _ in range(n_samples):
      j = rng.randint(k)
      rows = self._rows_sharing_factor(j, 2 * batch_size, rng)
      if rows is None or len(rows) < 2:
        continue
      half = len(rows) // 2
      z1, z2 = self.latents[rows[:half]], self.latents[rows[half:2 * half]]
      X.append(np.mean(np.abs(z1 - z2), 0))
      y.append(j)
    return np.asarray(X), np.asarray(y)

"""The port's counterparts of the sklearn pieces the posterior hub uses.

The JAX package scores latent spaces with sklearn on the host; the card
has no sklearn, so the port carries its own. Each name and attribute is
sklearn's (``labels_``, ``means_``, ``precisions_``,
``feature_importances_``), so the counterpart is found by name:

  * scores: ``adjusted_rand_score``, ``normalized_mutual_info_score``
    (arithmetic average), ``mutual_info_score`` (natural log),
    ``silhouette_score`` (Euclidean) and ``f1_score`` (binary; micro and
    macro over label columns; ``zero_division=0``): contingency tables and
    pairwise distances as torch ops in float64 (the pair counts of the
    ARI in int64). The silhouette's (n, n)
    distances are made ``_SIL_BUDGET`` bytes of rows at a time;
  * ``KMeans``: k-means++ seeding and Lloyd iterations with sklearn's
    ``tol`` (1e-4 × the mean feature variance), ``max_iter`` 300, empty
    clusters moved to the farthest points, and the restart of least
    inertia (a restart replaces the best only if its partition differs);
  * ``GaussianMixture``: 'full' and 'diag' covariances, ``init_params=
    'kmeans'`` (a one-restart KMeans), ``reg_covar`` 1e-6, ``tol`` 1e-3,
    the restart of highest lower bound, a final E-step;
  * ``LinearSVC``: squared hinge, L2, C = 1, the intercept penalised like
    a weight (liblinear's ``intercept_scaling=1``), solved exactly by
    generalised Newton steps in float64; a 2-D indicator ``y`` solves one
    problem per column (sklearn's ``OneVsRestClassifier``);
  * ``LogisticRegression``: C = 1, the intercept not penalised, binary for
    two classes and multinomial for more, solved by Newton steps in
    float64 to a gradient far below lbfgs's tolerance;
  * ``GradientBoostingClassifier``: log-loss, the class prior as the
    initial raw prediction, one regression tree per class a stage (one for
    two classes), squared-error trees grown on the host with one Newton
    step per leaf;
  * ``RandomForestRegressor``: bootstrapped squared-error trees grown on
    the host with the bootstrap counts as sample weights, and sklearn's
    feature importances.

Every entry point but the trees takes ``device`` (default
``'cuda'``, which must exist; ``'cpu'`` on request) and computes there,
whatever device its inputs lie on; fitted attributes stay on it.

The random draws are sklearn's: ``random_state`` is a numpy
``RandomState`` (an int seeds one, as ``check_random_state`` does), and
the k-means++ draws (the first centre, then 2 + ⌊ln k⌋ uniforms a centre)
are made with it on the host in sklearn's order, restarts and the
mixture's KMeans init drawing from the same stream. The Lloyd and EM
iterations run on ``device``. So the partitions are sklearn's except
where two choices differ by rounding alone: the device sums in another
order than sklearn's BLAS.

KMeans and GaussianMixture keep a float32 input in float32 and compute
everything else in float64, as sklearn does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import logit
from scipy.stats import gmean

__all__ = ["adjusted_rand_score", "normalized_mutual_info_score",
           "mutual_info_score", "silhouette_score", "f1_score", "KMeans",
           "GaussianMixture", "LinearSVC", "LogisticRegression",
           "GradientBoostingClassifier", "RandomForestRegressor"]

_SIL_BUDGET = 256 << 20   # bytes of one block of silhouette distances
_EPS64 = float(np.finfo(np.float64).eps)
# sklearn's defaults, the only values the JAX package uses
_KMEANS_MAX_ITER = 300
_KMEANS_TOL = 1e-4        # × the mean feature variance
_GMM_TOL = 1e-3           # on the change of the lower bound
_GMM_REG_COVAR = 1e-6
_C = 1.0                  # the linear classifiers' inverse regularization
_NEWTON_STEPS = 100
_LEARNING_RATE = 0.1      # the boosted trees'


# ---------------------------------------------------------------- helpers
def check_random_state(seed) -> np.random.RandomState:
  """sklearn's rule: None → numpy's global stream, an int → a new
  ``RandomState``, a ``RandomState`` → itself."""
  if seed is None:
    return np.random.mtrand._rand
  if isinstance(seed, np.random.RandomState):
    return seed
  return np.random.RandomState(int(seed))


def _resolve(device) -> torch.device:
  """The models' ``resolve_device``: 'cuda' must exist (no silent CPU
  fallback). Imported here, not at module level: the models package
  imports the analysis one."""
  from ..models.base import resolve_device
  return resolve_device(device)


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
  """``a`` as a tensor on ``device`` (None: where it lies)."""
  if isinstance(a, torch.Tensor):
    t = a.detach()
  else:
    t = torch.as_tensor(np.asarray(a))
  if device is not None:
    t = t.to(device)
  return t if dtype is None else t.to(dtype)


def _float_matrix(X, device) -> torch.Tensor:
  """X as a 2-D float tensor: float32 stays float32, anything else becomes
  float64 (sklearn's ``dtype=[np.float64, np.float32]``)."""
  t = _tensor(X, device=device)
  if t.ndim == 1:
    t = t[:, None]
  if t.ndim != 2:
    raise ValueError(f"expected a 2-D array, got shape {tuple(t.shape)}")
  return t if t.dtype == torch.float32 else t.to(torch.float64)


def _codes(labels, device) -> Tuple[torch.Tensor, int]:
  """Labels as codes 0…k-1 of their sorted distinct values, and k (names
  are coded on the host)."""
  if not isinstance(labels, torch.Tensor):
    a = np.asarray(labels).reshape(-1)
    if a.dtype.kind not in "biuf":
      uniq, inv = np.unique(a, return_inverse=True)
      return torch.as_tensor(inv, device=device), len(uniq)
  t = _tensor(labels, device=device).reshape(-1)
  if t.dtype == torch.bool:
    t = t.to(torch.int64)
  uniq, inv = torch.unique(t, sorted=True, return_inverse=True)
  return inv, int(uniq.numel())


def _two_codes(labels_true, labels_pred, device):
  dev = _resolve(device)
  a, na = _codes(labels_true, dev)
  b, nb = _codes(labels_pred, dev)
  if a.numel() != b.numel():
    raise ValueError(f"labels_true and labels_pred differ in length: "
                     f"{a.numel()} and {b.numel()}")
  return a, na, b, nb


def contingency_matrix(labels_true, labels_pred,
                       device="cuda") -> torch.Tensor:
  """(classes, clusters) int64 counts, on ``device``."""
  a, na, b, nb = _two_codes(labels_true, labels_pred, device)
  return torch.bincount(a * nb + b, minlength=na * nb).view(na, nb)


# ----------------------------------------------------------------- scores
def adjusted_rand_score(labels_true, labels_pred, device="cuda") -> float:
  """sklearn's ARI from the pair confusion matrix (int64 pair counts)."""
  c = contingency_matrix(labels_true, labels_pred, device)
  n = int(c.sum())
  n_c, n_k = c.sum(1), c.sum(0)
  # elementwise products: CUDA has no int64 matrix-vector product
  sums = torch.stack([(c * c).sum(), (c * n_k[None, :]).sum(),
                      (c * n_c[:, None]).sum()])
  sq, ck, cc = (int(v) for v in sums.tolist())
  tp = sq - n
  fp = ck - sq
  fn = cc - sq
  tn = n * n - fp - fn - sq
  if fn == 0 and fp == 0:
    return 1.0
  return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                      + (tp + fp) * (fp + tn))


def _mi_from_contingency(c: torch.Tensor) -> float:
  if c.shape[0] == 1 or c.shape[1] == 1:
    return 0.0
  c = c.to(torch.float64)
  total = c.sum()
  pi, pj = c.sum(1), c.sum(0)
  nzx, nzy = torch.nonzero(c, as_tuple=True)
  nz = c[nzx, nzy]
  nm = nz / total
  outer = (pi[nzx].to(torch.int64) * pj[nzy].to(torch.int64)).to(
      torch.float64)
  log_outer = -torch.log(outer) + torch.log(pi.sum()) + torch.log(pj.sum())
  mi = nm * (torch.log(nz) - torch.log(total)) + nm * log_outer
  mi = torch.where(mi.abs() < _EPS64, torch.zeros_like(mi), mi)
  return max(float(mi.sum()), 0.0)


def mutual_info_score(labels_true, labels_pred, device="cuda") -> float:
  """Mutual information of two labelings in nats (sklearn's formula)."""
  return _mi_from_contingency(contingency_matrix(labels_true, labels_pred,
                                                 device))


def _entropy(counts: torch.Tensor) -> float:
  pi = counts[counts > 0].to(torch.float64)
  if pi.numel() <= 1:
    return 0.0
  s = pi.sum()
  return float(-torch.sum((pi / s) * (torch.log(pi) - torch.log(s))))


def normalized_mutual_info_score(labels_true, labels_pred,
                                 device="cuda") -> float:
  """NMI with the arithmetic mean of the two entropies (sklearn's
  default); two single-cluster labelings score 1."""
  c = contingency_matrix(labels_true, labels_pred, device)
  if c.shape[0] == c.shape[1] and c.shape[0] <= 1:
    return 1.0
  mi = _mi_from_contingency(c)
  if mi == 0:
    return 0.0
  h_true, h_pred = _entropy(c.sum(1)), _entropy(c.sum(0))
  return float(mi / ((h_true + h_pred) / 2))


def silhouette_score(X, labels, device="cuda") -> float:
  """Mean silhouette coefficient, Euclidean, in float64 on ``device``;
  a member of a singleton cluster scores 0. Raises ``ValueError`` unless
  2 ≤ number of labels ≤ n − 1, as sklearn does. Distances are
  sklearn's ``sqrt(max(‖x‖² − 2x·y + ‖y‖², 0))`` with a zero diagonal,
  made in blocks of rows that fit ``_SIL_BUDGET`` bytes."""
  X = _tensor(X, torch.float64, _resolve(device))
  if X.ndim == 1:
    X = X[:, None]
  lab, k = _codes(labels, X.device)
  n = X.shape[0]
  if lab.numel() != n:
    raise ValueError(f"{lab.numel()} labels for {n} samples")
  if not 1 < k < n:
    raise ValueError(f"Number of labels is {k}. Valid values are 2 to "
                     "n_samples - 1 (inclusive)")
  freqs = torch.bincount(lab, minlength=k).to(torch.float64)
  sq = (X * X).sum(1)
  onehot = torch.zeros((n, k), dtype=torch.float64, device=X.device)
  onehot[torch.arange(n, device=X.device), lab] = 1.0
  rows = max(1, min(n, _SIL_BUDGET // (8 * n)))
  intra, inter = [], []
  for lo in range(0, n, rows):
    xb = X[lo:lo + rows]
    d = -2.0 * (xb @ X.T)
    d += sq[lo:lo + rows, None]
    d += sq[None, :]
    d.clamp_(min=0.0)
    r = torch.arange(xb.shape[0], device=X.device)
    d[r, lo + r] = 0.0
    d.sqrt_()
    cd = d @ onehot                                      # (rows, k)
    own = lab[lo:lo + rows]
    intra.append(cd[r, own].clone())
    cd[r, own] = math.inf
    inter.append((cd / freqs).min(1).values)
  a = torch.cat(intra) / (freqs - 1)[lab]
  b = torch.cat(inter)
  s = (b - a) / torch.maximum(a, b)
  return float(torch.nan_to_num(s, nan=0.0).mean())


def f1_score(y_true, y_pred, average: str = "binary",
             device="cuda") -> float:
  """F1 with ``zero_division=0``: ``average='binary'`` on 0/1 vectors
  (positive label 1); 'micro' and 'macro' over the columns of 0/1
  indicator matrices."""
  t = _tensor(y_true, device=_resolve(device))
  p = _tensor(y_pred, device=t.device)
  if t.shape != p.shape:
    raise ValueError(f"shapes differ: {tuple(t.shape)} and "
                     f"{tuple(p.shape)}")
  t, p = t != 0, p != 0
  if average == "binary":
    t, p = t.reshape(-1, 1), p.reshape(-1, 1)
  elif average not in ("micro", "macro"):
    raise ValueError(f"average must be 'binary', 'micro' or 'macro', got "
                     f"{average!r}")
  tp = (t & p).sum(0).to(torch.float64)
  fp = (~t & p).sum(0).to(torch.float64)
  fn = (t & ~p).sum(0).to(torch.float64)
  if average == "micro":
    tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
  den = 2 * tp + fp + fn
  f1 = torch.where(den > 0, 2 * tp / torch.where(den > 0, den, 1.0),
                   torch.zeros_like(den))
  return float(f1.mean())


# ------------------------------------------------------------------ KMeans
def _sq_distances(A: torch.Tensor, B: torch.Tensor,
                  b_sq: torch.Tensor) -> torch.Tensor:
  """sklearn's squared ``_euclidean_distances``: (len A, len B),
  ‖a‖² − 2a·b + ‖b‖² clipped at 0; float32 rows in float64, cast back,
  as sklearn upcasts them."""
  if A.dtype == torch.float32:
    A, B = A.double(), B.double()
    return _sq_distances(A, B, (B * B).sum(1)).float()
  d = -2.0 * (A @ B.T)
  d += (A * A).sum(1, keepdim=True)
  d += b_sq[None, :]
  return d.clamp_(min=0.0)


def _kmeans_plusplus(X: torch.Tensor, k: int, x_sq: torch.Tensor,
                     rs: np.random.RandomState) -> torch.Tensor:
  """sklearn's greedy k-means++ (``_kmeans_plusplus``): the draws on the
  host, the distances and potentials on X's device."""
  n = X.shape[0]
  trials = 2 + int(np.log(k))
  w = np.ones(n, np.float32 if X.dtype == torch.float32 else np.float64)
  first = rs.choice(n, p=w / w.sum())
  idx = torch.empty(k, dtype=torch.int64, device=X.device)
  idx[0] = int(first)
  closest = _sq_distances(X[first:first + 1], X, x_sq)[0]
  pot = closest.sum()
  for c in range(1, k):
    # numpy multiplies and compares in float64 whatever X's dtype
    u = torch.as_tensor(rs.uniform(size=trials), device=X.device)
    cand = torch.searchsorted(torch.cumsum(closest, 0).double(),
                              u * pot.double())
    cand.clamp_(max=n - 1)
    dist = torch.minimum(closest[None, :], _sq_distances(X[cand], X, x_sq))
    pots = dist.sum(1)
    best = torch.argmin(pots)
    pot, closest = pots[best], dist[best]
    idx[c] = cand[best]
  return X[idx].clone()


def _assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
  """Nearest centre of each row (first on ties): argmin of ‖c‖² − 2x·c."""
  return torch.argmin((C * C).sum(1)[None, :] - 2.0 * (X @ C.T), dim=1)


def _inertia(X, C, labels) -> torch.Tensor:
  return ((X - C[labels]) ** 2).sum()


def _same_clustering(l1: torch.Tensor, l2: torch.Tensor, k: int) -> bool:
  """sklearn's ``_is_same_clustering``: every cluster of ``l1`` maps to
  one cluster of ``l2``."""
  pairs = torch.unique(l1 * k + l2).numel()
  return pairs == torch.unique(l1).numel()


def _lloyd(X: torch.Tensor, C: torch.Tensor, max_iter: int, tol: float):
  """sklearn's ``_kmeans_single_lloyd``: (labels, inertia, centres,
  iterations)."""
  n, k = X.shape[0], C.shape[0]
  labels_old = torch.full((n,), -1, dtype=torch.int64, device=X.device)
  strict = False
  for it in range(max_iter):
    labels = _assign(X, C)
    counts = torch.bincount(labels, minlength=k).to(X.dtype)
    sums = torch.zeros_like(C).index_add_(0, labels, X)
    empty = torch.nonzero(counts == 0)[:, 0]
    if empty.numel():
      _relocate_empty(X, C, sums, counts, labels, empty)
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp(min=1)[:, None], sums)
    shift = torch.sqrt(((new - C) ** 2).sum(1))
    done, shift_tot = torch.stack([
        (labels == labels_old).all().to(X.dtype),
        (shift ** 2).sum()]).tolist()
    C = new
    if done:
      strict = True
      break
    if shift_tot <= tol:
      break
    labels_old = labels
  if not strict:
    labels = _assign(X, C)
  return labels, float(_inertia(X, C, labels)), C, it + 1


def _relocate_empty(X, C_old, sums, counts, labels, empty):
  """sklearn's ``_relocate_empty_clusters_dense``: each empty cluster
  takes one of the points farthest from their centres (chosen with
  numpy's ``argpartition`` on the host, as sklearn chooses them)."""
  dist = ((X - C_old[labels]) ** 2).sum(1).cpu().numpy()
  if dist.max() == 0:
    return
  m = len(empty)
  far = np.argpartition(dist, -m)[:-m - 1:-1]
  for new_id, f in zip(empty.tolist(), far.tolist()):
    old = int(labels[f])
    sums[old] -= X[f]
    sums[new_id] = X[f]
    counts[new_id] = 1.0
    counts[old] -= 1.0


class KMeans:
  """sklearn's ``KMeans(algorithm='lloyd', init='k-means++')``.

  After ``fit``: ``labels_`` (int64 tensor), ``cluster_centers_``,
  ``inertia_`` (float), ``n_iter_``, on ``device``. The data are centred
  before the runs, as in sklearn."""

  def __init__(self, n_clusters: int = 8, n_init: int = 10,
               random_state=None, device="cuda"):
    self.n_clusters = int(n_clusters)
    self.n_init = int(n_init)
    self.random_state = random_state
    self.device = device

  def fit(self, X, y=None) -> "KMeans":
    X = _float_matrix(X, _resolve(self.device))
    n, k = X.shape[0], self.n_clusters
    if n < k:
      raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
    rs = check_random_state(self.random_state)
    tol = float(X.var(0, correction=0).mean()) * _KMEANS_TOL
    mean = X.mean(0)
    Xc = X - mean
    x_sq = (Xc * Xc).sum(1)
    best = None
    for _ in range(self.n_init):
      C0 = _kmeans_plusplus(Xc, k, x_sq, rs)
      labels, inertia, C, n_iter = _lloyd(Xc, C0, _KMEANS_MAX_ITER, tol)
      if best is None or (inertia < best[1]
                          and not _same_clustering(labels, best[0], k)):
        best = (labels, inertia, C, n_iter)
    self.labels_, self.inertia_, C, self.n_iter_ = best
    self.cluster_centers_ = C + mean
    return self

  def fit_predict(self, X, y=None) -> torch.Tensor:
    return self.fit(X).labels_

  def predict(self, X) -> torch.Tensor:
    X = _float_matrix(X, self.cluster_centers_.device)
    return _assign(X, self.cluster_centers_.to(X.dtype))


# --------------------------------------------------------- GaussianMixture
_PRECISION_ERROR = ("Fitting the mixture model failed because some "
                    "components have ill-defined empirical covariance (for "
                    "instance caused by singleton or collapsed samples). "
                    "Try to decrease the number of components, increase "
                    "reg_covar, or scale the input data.")


class GaussianMixture:
  """sklearn's ``GaussianMixture`` for ``covariance_type`` 'full' and
  'diag', with its ``init_params='kmeans'`` (a one-restart KMeans),
  ``reg_covar`` 1e-6 and ``tol`` 1e-3.

  After ``fit``: ``weights_``, ``means_``, ``covariances_``,
  ``precisions_cholesky_``, ``precisions_`` (tensors on ``device``),
  ``converged_``, ``n_iter_``, ``lower_bound_``. Raises
  ``ValueError`` where sklearn does: fewer than 2 samples or fewer
  samples than components, and a covariance that is not positive
  definite."""

  def __init__(self, n_components: int = 1, covariance_type: str = "full",
               max_iter: int = 100, n_init: int = 1, random_state=None,
               device="cuda"):
    if covariance_type not in ("full", "diag"):
      raise ValueError(f"covariance_type must be 'full' or 'diag', got "
                       f"{covariance_type!r}")
    if int(max_iter) < 1:
      raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    self.n_components = int(n_components)
    self.covariance_type = covariance_type
    self.max_iter = int(max_iter)
    self.n_init = int(n_init)
    self.random_state = random_state
    self.device = device

  # -------------------------------------------------------------- M-step
  def _estimate(self, X: torch.Tensor, resp: torch.Tensor):
    nk = resp.sum(0) + 10 * float(torch.finfo(resp.dtype).eps)
    means = (resp.T @ X) / nk[:, None]
    if self.covariance_type == "diag":
      cov = (resp.T @ (X * X)) / nk[:, None] - means ** 2 + _GMM_REG_COVAR
      if bool((cov <= 0).any()):
        raise ValueError(_PRECISION_ERROR)
      chol = 1.0 / torch.sqrt(cov)
    else:
      d = X.shape[1]
      diff = X[None, :, :] - means[:, None, :]           # (K, n, d)
      cov = torch.einsum("kn,kni,knj->kij", resp.T, diff, diff) \
          / nk[:, None, None]
      cov = cov + _GMM_REG_COVAR * torch.eye(d, dtype=X.dtype,
                                             device=X.device)
      L, info = torch.linalg.cholesky_ex(cov)
      if bool((info != 0).any()):
        raise ValueError(_PRECISION_ERROR)
      eye = torch.eye(d, dtype=X.dtype, device=X.device).expand_as(L)
      chol = torch.linalg.solve_triangular(L, eye, upper=False).transpose(
          1, 2)
    return nk, means, cov, chol

  def _m_step(self, X, resp):
    nk, self.means_, self.covariances_, self.precisions_cholesky_ = \
        self._estimate(X, resp)
    self.weights_ = nk / nk.sum()

  # -------------------------------------------------------------- E-step
  def _log_gaussian(self, X: torch.Tensor) -> torch.Tensor:
    d = X.shape[1]
    chol, means = self.precisions_cholesky_, self.means_
    if self.covariance_type == "diag":
      log_det = torch.log(chol).sum(1)
      prec = chol ** 2
      lp = ((means ** 2) * prec).sum(1)[None, :] \
          - 2.0 * (X @ (means * prec).T) + (X ** 2) @ prec.T
    else:
      log_det = torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(1)
      y = torch.einsum("nd,kde->nke", X, chol) \
          - torch.einsum("kd,kde->ke", means, chol)[None]
      lp = (y * y).sum(2)
    return -0.5 * (d * math.log(2 * math.pi) + lp) + log_det[None, :]

  def _weighted_log_prob(self, X):
    return self._log_gaussian(X) + torch.log(self.weights_)[None, :]

  def _e_step(self, X):
    w = self._weighted_log_prob(X)
    norm = torch.logsumexp(w, 1)
    return norm.mean(), w - norm[:, None]

  # ----------------------------------------------------------------- fit
  def _params(self):
    return (self.weights_, self.means_, self.covariances_,
            self.precisions_cholesky_)

  def fit_predict(self, X, y=None) -> torch.Tensor:
    X = _float_matrix(X, _resolve(self.device))
    n, K = X.shape[0], self.n_components
    if n < 2:
      raise ValueError(f"Found array with {n} sample(s) while a minimum of "
                       "2 is required.")
    if n < K:
      raise ValueError(f"Expected n_samples >= n_components but got "
                       f"n_components = {K}, n_samples = {n}")
    rs = check_random_state(self.random_state)
    best, best_lb, best_iter = None, -math.inf, 0
    self.converged_ = False
    for _ in range(self.n_init):
      labels = KMeans(K, n_init=1, random_state=rs,
                      device=X.device).fit(X).labels_
      resp = torch.zeros((n, K), dtype=X.dtype, device=X.device)
      resp[torch.arange(n, device=X.device), labels] = 1.0
      nk, self.means_, self.covariances_, self.precisions_cholesky_ = \
          self._estimate(X, resp)
      self.weights_ = nk / n
      lb, converged = -math.inf, False
      for n_iter in range(1, self.max_iter + 1):
        prev = lb
        norm, log_resp = self._e_step(X)
        self._m_step(X, torch.exp(log_resp))
        lb = float(norm)
        if abs(lb - prev) < _GMM_TOL:
          converged = True
          break
      if lb > best_lb or best_lb == -math.inf:
        best, best_lb, best_iter = self._params(), lb, n_iter
        self.converged_ = converged
    (self.weights_, self.means_, self.covariances_,
     self.precisions_cholesky_) = best
    self.n_iter_, self.lower_bound_ = best_iter, best_lb
    if self.covariance_type == "diag":
      self.precisions_ = self.precisions_cholesky_ ** 2
    else:
      c = self.precisions_cholesky_
      self.precisions_ = c @ c.transpose(1, 2)
    return torch.argmax(self._e_step(X)[1], 1)

  def fit(self, X, y=None) -> "GaussianMixture":
    self.fit_predict(X)
    return self

  def _input(self, X):
    return _float_matrix(X, self.means_.device).to(self.means_.dtype)

  def predict(self, X) -> torch.Tensor:
    return torch.argmax(self._weighted_log_prob(self._input(X)), 1)

  def predict_proba(self, X) -> torch.Tensor:
    return torch.exp(self._e_step(self._input(X))[1])

  def score_samples(self, X) -> torch.Tensor:
    return torch.logsumexp(self._weighted_log_prob(self._input(X)), 1)

  def score(self, X, y=None) -> float:
    return float(self.score_samples(X).mean())


# -------------------------------------------------------- linear classifiers
def _with_intercept(X: torch.Tensor) -> torch.Tensor:
  return torch.cat([X, torch.ones_like(X[:, :1])], 1)


def _newton(fun, w: torch.Tensor, max_iter: int, gtol: float):
  """Minimise a convex ``fun(w) → (f, g, H)`` over a batch of problems
  (leading axis of ``w``) by Newton steps with Armijo backtracking, until
  every gradient entry is within ``gtol`` or no step decreases ``f`` any
  more (the minimum to rounding)."""
  for _ in range(max_iter):
    f, g, H = fun(w)
    if float(g.abs().max()) <= gtol:
      break
    step = torch.linalg.solve(H, g.unsqueeze(-1)).squeeze(-1)
    slope = (g * step).sum(-1)
    t = torch.ones_like(f)
    for _ in range(40):
      ok = fun(w - t[:, None] * step, value_only=True) \
          <= f - 1e-4 * t * slope
      if bool(ok.all()):
        break
      t = torch.where(ok, t, t / 2)
    else:
      break
    w = w - t[:, None] * step
  return w


class LinearSVC:
  """sklearn's ``LinearSVC()`` as liblinear's primal solves it (the
  sklearn default for more samples than features): squared hinge, L2,
  C = 1, the intercept a weight on a constant feature of 1 and penalised
  with the rest:

      ½‖[w, b]‖² + C Σᵢ max(0, 1 − yᵢ(w·xᵢ + b))²,  yᵢ = ±1.

  The objective is convex and piecewise quadratic; generalised Newton
  steps in float64 reach its minimum, where liblinear stops at a relative
  gradient of ``tol``. ``y`` 1-D: one problem over its two classes; ``y``
  a 0/1 indicator matrix: one problem per column, solved together
  (sklearn's ``OneVsRestClassifier(LinearSVC())``). sklearn's
  ``random_state`` only seeds liblinear's dual solvers: there is none
  here. Fits on ``device``."""

  def __init__(self, device="cuda"):
    self.device = device

  def fit(self, X, y) -> "LinearSVC":
    X = _with_intercept(_tensor(X, torch.float64, _resolve(self.device)))
    y = _tensor(y, device=X.device)
    self._multilabel = y.ndim == 2
    if self._multilabel:
      self.classes_ = None
      ypm = (y != 0).T.to(torch.float64) * 2 - 1          # (L, n)
    else:
      self.classes_, codes = torch.unique(y, return_inverse=True)
      if self.classes_.numel() != 2:
        raise ValueError(f"LinearSVC here is binary; got "
                         f"{self.classes_.numel()} classes")
      ypm = (codes.to(torch.float64) * 2 - 1)[None, :]
    C, d = _C, X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)

    def fun(w, value_only=False):
      m = 1 - ypm * (w @ X.T)                              # (L, n)
      act = (m > 0).to(X.dtype)
      f = 0.5 * (w * w).sum(1) + C * (act * m * m).sum(1)
      if value_only:
        return f
      g = w - 2 * C * (act * m * ypm) @ X
      H = eye + 2 * C * torch.einsum("ln,ni,nj->lij", act, X, X)
      return f, g, H
    w = torch.zeros((ypm.shape[0], d), dtype=X.dtype, device=X.device)
    w = _newton(fun, w, _NEWTON_STEPS, 1e-10)
    self.coef_, self.intercept_ = w[:, :-1], w[:, -1]
    return self

  def decision_function(self, X) -> torch.Tensor:
    X = _tensor(X, torch.float64, self.coef_.device)
    out = X @ self.coef_.T + self.intercept_[None, :]
    return out if self._multilabel else out[:, 0]

  def predict(self, X) -> torch.Tensor:
    pos = self.decision_function(X) > 0
    if self._multilabel:
      return pos.to(torch.int64)
    return self.classes_[pos.to(torch.int64)]


class LogisticRegression:
  """sklearn's ``LogisticRegression(solver='lbfgs')``: the log-loss summed
  over samples plus ½‖W‖²/C with C = 1, the intercept not penalised; one
  weight vector for two classes, multinomial (one per class) for more.
  The optimum is unique in W, so Newton steps in float64 to a gradient of
  1e-10 reach the point lbfgs approaches within its tolerance (``tol``
  1e-4 on the gradient; its ``max_iter`` bounds lbfgs, not these steps).
  A multinomial's intercepts are defined up to a common shift, which
  moves no prediction. Fits on ``device``."""

  def __init__(self, device="cuda"):
    self.device = device

  def fit(self, X, y) -> "LogisticRegression":
    X = _with_intercept(_tensor(X, torch.float64, _resolve(self.device)))
    y = _tensor(y, device=X.device)
    self.classes_, codes = torch.unique(y, return_inverse=True)
    K = int(self.classes_.numel())
    if K < 2:
      raise ValueError("This solver needs samples of at least 2 classes in "
                       f"the data, but the data contains only one class: "
                       f"{self.classes_.tolist()}")
    n, d = X.shape
    reg = torch.ones(d, dtype=X.dtype, device=X.device) / _C
    reg[-1] = 0.0
    if K == 2:
      s = codes.to(torch.float64)

      def fun(w, value_only=False):
        z = X @ w[0]
        f = (torch.nn.functional.softplus(z) - s * z).sum() \
            + 0.5 * (reg * w[0] ** 2).sum()
        if value_only:
          return f[None]
        p = torch.sigmoid(z)
        g = X.T @ (p - s) + reg * w[0]
        H = (X.T * (p * (1 - p))) @ X + torch.diag(reg)
        return f[None], g[None], H[None]
      w = torch.zeros((1, d), dtype=X.dtype, device=X.device)
    else:
      Y = torch.nn.functional.one_hot(codes, K).to(X.dtype)
      R = reg.repeat(K)
      damp = 1e-12 * torch.eye(K * d, dtype=X.dtype, device=X.device)

      def fun(w, value_only=False):
        W = w[0].view(K, d)
        Z = X @ W.T
        f = (torch.logsumexp(Z, 1) - (Y * Z).sum(1)).sum() \
            + 0.5 * (R * w[0] ** 2).sum()
        if value_only:
          return f[None]
        P = torch.softmax(Z, 1)
        g = ((P - Y).T @ X).reshape(-1) + R * w[0]
        A = torch.diag_embed(P) - P[:, :, None] * P[:, None, :]   # (n,K,K)
        H = torch.einsum("nkl,ni,nj->kilj", A, X, X).reshape(K * d, K * d)
        return f[None], g[None], (H + torch.diag(R) + damp)[None]
      w = torch.zeros((1, K * d), dtype=X.dtype, device=X.device)
    w = _newton(fun, w, _NEWTON_STEPS, 1e-10)[0]
    W = w.view(-1, d)
    self.coef_, self.intercept_ = W[:, :-1], W[:, -1]
    return self

  def decision_function(self, X) -> torch.Tensor:
    X = _tensor(X, torch.float64, self.coef_.device)
    out = X @ self.coef_.T + self.intercept_[None, :]
    return out[:, 0] if out.shape[1] == 1 else out

  def predict(self, X) -> torch.Tensor:
    z = self.decision_function(X)
    idx = (z > 0).to(torch.int64) if z.ndim == 1 else torch.argmax(z, 1)
    return self.classes_[idx]

  def score(self, X, y) -> float:
    """Accuracy: the count of right predictions over n (exact, where a
    device mean would round in its own order)."""
    pred = self.predict(X)
    y = _tensor(y, device=pred.device).reshape(-1)
    return int((pred == y).sum()) / y.numel()


# ---------------------------------------------------------- boosted trees
_FEATURE_THRESHOLD = 1e-7   # sklearn's: closer values count as equal
_RAND_R_MAX = 2147483647


class _RandR:
  """sklearn's ``our_rand_r`` xorshift, which orders the features a tree
  node visits (``rand_int(low, high)``)."""

  def __init__(self, seed: int):
    self.state = int(seed) & 0xFFFFFFFF

  def rand_int(self, low: int, high: int) -> int:
    s = self.state or 1
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    self.state = s
    return low + (s % (_RAND_R_MAX + 1)) % (high - low)


def _seq_sum(a: np.ndarray) -> float:
  """A sum in order from 0.0, as sklearn's criterion accumulates (numpy's
  ``sum`` adds pairwise)."""
  return float(np.cumsum(a)[-1]) if len(a) else 0.0


def _left_sums(ys: np.ndarray, pos: np.ndarray, total: float) -> np.ndarray:
  """sklearn's ``sum_left`` at each split position ``pos`` (ascending) of
  one feature: running sums from the node's first sample, except where a
  position lies nearer the end than the one before, where sklearn
  restarts from the node total and subtracts from the end, then runs on
  from there. Each run is one sequential ``cumsum`` (or
  ``subtract.accumulate``), so every sum is sklearn's, in its order."""
  m = len(ys)
  prev = np.concatenate([[0], pos[:-1]])
  restarts = np.flatnonzero((pos - prev) > (m - pos))
  if not len(restarts):
    return np.cumsum(ys)[pos - 1]
  out = np.empty(len(pos))
  first = restarts[0]
  if first:
    out[:first] = np.cumsum(ys[:pos[first - 1]])[pos[:first] - 1]
  bounds = list(restarts) + [len(pos)]
  for r, stop in zip(restarts, bounds[1:]):
    p = int(pos[r])
    base = float(np.subtract.accumulate(
        np.concatenate([[total], ys[:p - 1:-1]]))[-1])
    out[r] = base
    if stop > r + 1:
      run = pos[r + 1:stop]
      out[r + 1:stop] = np.cumsum(np.concatenate(
          [[base], ys[p:run[-1]]]))[run - p]
  return out


def _partition(seg: np.ndarray, left: np.ndarray) -> np.ndarray:
  """sklearn's ``partition_samples_final`` order of the node's samples
  ``seg`` (``left`` flags each one): its two-pointer swaps examine the
  samples from the front until a right-goer (swapped to the back), then
  from the back until a left-goer, and so on until the pointers meet.
  Left-goers fill the front in the order examined, right-goers the back.
  Computed here from the phases: front phase k takes the left-goers
  before the k-th right-goer R[k], back phase k the right-goers after the
  k-th left-goer from the end LB[k]."""
  m = len(seg)
  R = np.flatnonzero(~left)                 # right-goers, ascending
  LB = np.flatnonzero(left)[::-1]           # left-goers, descending
  k = min(len(R), len(LB))
  ok = R[:k] < LB[:k]
  K = k if ok.all() else int(np.argmin(ok))  # complete front/back pairs
  lb_prev = LB[K - 1] if K else m
  last = R[K] if K < len(R) and R[K] < lb_prev else lb_prev - 1
  pos = np.arange(m)
  front = pos <= last                       # examined from the front
  lf, lb = pos[left & front], pos[left & ~front]
  rf, rb = pos[~left & front], pos[~left & ~front]
  # (phase, then after the front phase's samples, then position)
  lkey = np.concatenate([2 * np.searchsorted(R, lf),
                         2 * (len(lb) - 1 - np.arange(len(lb))) + 1])
  lpos = np.concatenate([lf, np.zeros(len(lb), np.int64)])
  rkey = np.concatenate([2 * np.arange(len(rf)),
                         2 * np.searchsorted(-LB, -rb) + 1])
  rpos = np.concatenate([np.zeros(len(rf), np.int64), -rb])
  left_part = np.concatenate([lf, lb])[np.lexsort((lpos, lkey))]
  right_part = np.concatenate([rf, rb])[np.lexsort((rpos, rkey))][::-1]
  return seg[np.concatenate([left_part, right_part])]


class _Tree:
  """A regression tree in sklearn's node order and layout: per node
  ``feature``, ``threshold`` (float64), ``left``/``right`` (-1 at a
  leaf), ``impurity``, ``n_samples`` (sklearn's
  ``weighted_n_node_samples``) and ``value``."""

  def __init__(self):
    self.feature, self.threshold, self.left, self.right = [], [], [], []
    self.impurity, self.n_samples, self.value = [], [], []

  @property
  def node_count(self) -> int:
    return len(self.value)

  def apply(self, X32: np.ndarray) -> np.ndarray:
    """The leaf of each row of float32 X (``x <= threshold`` goes left,
    the float32 value against the float64 threshold)."""
    node = np.zeros(len(X32), np.int64)
    feat = np.asarray(self.feature)
    thr = np.asarray(self.threshold)
    left, right = np.asarray(self.left), np.asarray(self.right)
    rows = np.arange(len(X32))
    while True:
      inner = left[node] >= 0
      if not inner.any():
        return node
      r, nd = rows[inner], node[inner]
      go_left = X32[r, feat[nd]].astype(np.float64) <= thr[nd]
      node[r] = np.where(go_left, left[nd], right[nd])

  def importances(self, n_features: int) -> np.ndarray:
    """sklearn's ``compute_feature_importances(normalize=False)``."""
    imp = np.zeros(n_features)
    w = np.asarray(self.n_samples, np.float64)
    h = np.asarray(self.impurity)
    for i, f in enumerate(self.feature):
      if self.left[i] >= 0:
        imp[f] += w[i] * h[i] - w[self.left[i]] * h[self.left[i]] \
            - w[self.right[i]] * h[self.right[i]]
    return imp / w[0]


class _TreeBuilder:
  """sklearn's ``DepthFirstTreeBuilder`` with the best splitter and the
  squared-error criterion (``min_samples_split`` 2, ``min_samples_leaf``
  1), at unit sample weights or at given ones (a forest's bootstrap
  counts: the samples of weight 0 are left out, every sum weighs w·y, in
  sklearn's order), followed step by step: the features each
  node visits, in the order ``rand_r`` draws them; the samples array that
  each visit sorts and the final split partitions; and every sum the
  criterion forms, in its order. So a split's proxy (sum_l²/n_l +
  sum_r²/n_r) is sklearn's to the bit, and a near tie between features
  goes the same way. Exactly equal float32 values within a node are the
  one place the order can differ: here they keep the row order, while
  sklearn's introsort leaves them in an order of its own."""

  def __init__(self, X32: np.ndarray, order: np.ndarray, max_depth: int,
               seed: int, weights: Optional[np.ndarray] = None):
    self.X, self.order, self.max_depth = X32, order, int(max_depth)
    self.rng = _RandR(seed)
    n, d = X32.shape
    # sklearn's splitter keeps only the samples of nonzero weight
    self.w = np.ones(n) if weights is None else np.asarray(weights,
                                                             np.float64)
    self.samples = np.flatnonzero(self.w != 0.0).astype(np.int64)
    self.features = np.arange(d, dtype=np.int64)
    self.constant = np.zeros(d, np.int64)

  def _split(self, start, end, y, n_known):
    """sklearn's ``node_split_best`` on samples[start:end]: (feature,
    position, threshold) or None, and the node's constant-feature count
    for its children."""
    X, feats, rng, w = self.X, self.features, self.rng, self.w
    d = X.shape[1]
    wy = w * y
    total = _seq_sum(wy[self.samples[start:end]])
    w_total = _seq_sum(w[self.samples[start:end]])
    # every feature's node samples in ascending order: the presorted rows
    # filtered by membership (a sort of the node's values, ties apart)
    member = np.zeros(len(X), bool)
    member[self.samples[start:end]] = True
    by_feature = self.order[member[self.order]].reshape(d, end - start)
    last = None
    f_i, visited, found, drawn = d, 0, 0, 0
    n_total = n_known
    best, best_proxy = None, -np.inf
    while f_i > n_total and (visited < d or visited <= found + drawn):
      visited += 1
      f_j = rng.rand_int(drawn, f_i - found)
      if f_j < n_known:
        feats[drawn], feats[f_j] = feats[f_j], feats[drawn]
        drawn += 1
        continue
      f_j += found
      f = last = int(feats[f_j])
      seg = by_feature[f]
      xs = X[seg, f].astype(np.float64)
      if xs[-1] <= xs[0] + _FEATURE_THRESHOLD:
        feats[f_j], feats[n_total] = feats[n_total], feats[f_j]
        found += 1
        n_total += 1
        continue
      f_i -= 1
      feats[f_i], feats[f_j] = feats[f_j], feats[f_i]
      m = len(seg)
      pos = 1 + np.nonzero(xs[1:] > xs[:-1] + _FEATURE_THRESHOLD)[0]
      sl = _left_sums(wy[seg], pos, total)
      sr = total - sl
      wl = _left_sums(w[seg], pos, w_total)
      proxy = sl * sl / wl + sr * sr / (w_total - wl)
      k = int(np.argmax(proxy))
      if proxy[k] > best_proxy:
        p = int(pos[k])
        best_proxy = proxy[k]
        best = (f, start + p, xs[p - 1] / 2.0 + xs[p] / 2.0)
    if last is not None:  # each visit sorts the samples: the last stays
      self.samples[start:end] = by_feature[last]
    feats[:n_known] = self.constant[:n_known]
    self.constant[n_known:n_known + found] = feats[n_known:n_known + found]
    return best, n_total

  def build(self, y: np.ndarray) -> Tuple[_Tree, np.ndarray]:
    """The tree fitted to ``y`` and the leaf of every row."""
    tree = _Tree()
    w = self.w
    wy = w * y
    leaf_of = np.zeros(len(y), np.int64)
    seg = self.samples
    n = len(seg)
    w_n = _seq_sum(w[seg])
    total, sq_total = _seq_sum(wy[seg]), _seq_sum(wy[seg] * y[seg])
    root_imp = sq_total / w_n - (total / w_n) ** 2.0
    # (start, end, depth, parent, is_left, impurity, n_constant)
    stack = [(0, n, 0, -1, False, root_imp, 0)]
    while stack:
      start, end, depth, parent, is_left, impurity, n_const = stack.pop()
      m = end - start
      seg = self.samples[start:end]
      wm = _seq_sum(w[seg])
      total, sq_total = _seq_sum(wy[seg]), _seq_sum(wy[seg] * y[seg])
      split = None
      if not (depth >= self.max_depth or m < 2 or impurity <= _EPS64):
        split, n_const = self._split(start, end, y, n_const)
      if split is not None:
        f, pos, thr = split
        seg = _partition(self.samples[start:end],
                         self.X[self.samples[start:end], f].astype(
                             np.float64) <= thr)
        self.samples[start:end] = seg
        wys, ws, nl, nr = wy[seg], w[seg], pos - start, end - pos

        def left(a, whole):
          return (_seq_sum(a[:nl]) if nl <= nr else float(
              np.subtract.accumulate(np.concatenate([[whole],
                                                     a[:nl - 1:-1]]))[-1]))
        sl, wl = left(wys, total), left(ws, wm)
        sr, wr = total - sl, wm - wl
        sq_l = _seq_sum(wys[:nl] * y[seg][:nl])
        imp_l = sq_l / wl - (sl / wl) ** 2.0
        imp_r = (sq_total - sq_l) / wr - (sr / wr) ** 2.0
        gain = (wm / w_n) * (impurity - wr / wm * imp_r - wl / wm * imp_l)
        if gain + _EPS64 < 0.0:   # min_impurity_decrease 0
          split = None
      node = tree.node_count
      if parent >= 0:
        (tree.left if is_left else tree.right)[parent] = node
      tree.impurity.append(impurity)
      tree.n_samples.append(wm)
      tree.value.append(total / wm)
      tree.left.append(-1)
      tree.right.append(-1)
      if split is None:
        tree.feature.append(-2)
        tree.threshold.append(-2.0)
        leaf_of[self.samples[start:end]] = node
        continue
      tree.feature.append(f)
      tree.threshold.append(thr)
      stack.append((pos, end, depth + 1, node, False, imp_r, n_const))
      stack.append((start, pos, depth + 1, node, True, imp_l, n_const))
    return tree, leaf_of


def _build_tree(X32: np.ndarray, order: np.ndarray, max_depth: int,
                seed: int, y: np.ndarray, weights: Optional[np.ndarray] = None
                ) -> Tuple[_Tree, np.ndarray]:
  """``_TreeBuilder(X32, order, max_depth, seed, weights).build(y)`` in
  C++ (``native/gbtree.cpp``, the same steps and the same bits): the tree
  and the leaf of every row."""
  from .. import native
  X32 = np.ascontiguousarray(X32, np.float32)
  order = np.ascontiguousarray(order, np.int64)
  n, d = X32.shape
  w = (np.ones(n) if weights is None else
       np.ascontiguousarray(weights, np.float64))
  y = np.ascontiguousarray(y, np.float64)
  # the library reads through raw pointers: check every shape it assumes
  if order.shape != (d, n) or w.shape != (n,) or y.shape != (n,):
    raise ValueError(f"order {order.shape}, weights {w.shape}, y {y.shape}"
                     f" for X {X32.shape}: expected ({d}, {n}), ({n},)")
  if n and (order.min() < 0 or order.max() >= n):
    raise IndexError(f"order holds a row outside [0, {n})")
  cap = max(1, 2 * int(np.count_nonzero(w)) - 1)
  feature, left, right = (np.empty(cap, np.int64) for _ in range(3))
  threshold, impurity, n_samples, value = (np.empty(cap) for _ in range(4))
  leaf_of = np.empty(n, np.int64)
  count = native.load("gbtree").gbtree_build(
      X32.ctypes.data, n, d, order.ctypes.data, w.ctypes.data, y.ctypes.data,
      min(int(max_depth), np.iinfo(np.int64).max), int(seed) & 0xFFFFFFFF,
      cap, *(a.ctypes.data for a in (feature, threshold, left, right,
                                     impurity, n_samples, value, leaf_of)))
  if count < 0:
    raise RuntimeError(f"tree of more than {cap} nodes")
  tree = _Tree()
  tree.feature, tree.threshold = feature[:count].tolist(), \
      threshold[:count].tolist()
  tree.left, tree.right = left[:count].tolist(), right[:count].tolist()
  tree.impurity, tree.n_samples = impurity[:count].tolist(), \
      n_samples[:count].tolist()
  tree.value = value[:count].tolist()
  return tree, leaf_of


class GradientBoostingClassifier:
  """sklearn's ``GradientBoostingClassifier`` at its defaults (log-loss,
  learning rate 0.1, ``subsample`` 1, the class prior as the initial raw
  prediction), with ``n_estimators`` and ``max_depth``.

  Each stage fits one squared-error regression tree per class (one for
  two classes) to the negative gradient, then sets each leaf to one
  Newton step, Σg / Σp(1−p), scaled by (K−1)/K for K > 2 classes. As in
  sklearn, X is cast to float32, a split lies at the midpoint of two
  consecutive distinct values (values within 1e-7 count as equal), and a
  row goes left when its float32 value is ≤ the float64 threshold. The
  tree's split proxy is sklearn 1.9's squared-error one; its
  'friedman_mse' proxy orders the splits the same.

  The trees are grown on the host in C++ (``_build_tree``, whose plain
  reference is ``_TreeBuilder`` in numpy): a
  node's split search is sequential and tiny (at most 7 nodes a tree at
  depth 3, a few thousand rows, a handful of features), and sklearn's
  choice between near-equal splits depends on the order of every sum it
  forms, which the builder follows step by step; the card would spend
  more on launches and syncs than the work takes. ``random_state`` seeds
  the order in which each node visits the features (one draw a tree), as
  in sklearn."""

  def __init__(self, n_estimators: int = 100, max_depth: int = 3,
               random_state=None):
    self.n_estimators = int(n_estimators)
    self.max_depth = int(max_depth)
    self.random_state = random_state

  @staticmethod
  def _host32(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
      X = X.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(X, np.float32))

  def fit(self, X, y) -> "GradientBoostingClassifier":
    X32 = self._host32(X)
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
    self.classes_, codes = np.unique(np.asarray(y).ravel(),
                                     return_inverse=True)
    K = len(self.classes_)
    if K < 2:
      raise ValueError("y contains 1 class after sample_weight trimmed "
                       "classes with zero weights, while a minimum of 2 "
                       "classes are required.")
    n, d = X32.shape
    self.n_features_in_ = d
    prior = np.bincount(codes, minlength=K) / n
    eps = np.finfo(np.float64).eps
    if K == 2:
      self._init = np.array([logit(np.clip(prior[1], eps, 1 - eps))])
    else:  # sklearn's symmetric multinomial link: log(p / gmean(p))
      pc = np.clip(prior, eps, 1 - eps)[None, :]
      self._init = np.log(pc / gmean(pc, axis=1)[:, None])[0]
    T = 1 if K == 2 else K
    raw = np.tile(self._init, (n, 1))
    rs = check_random_state(self.random_state)
    order = np.argsort(X32, axis=0, kind="stable").T.copy()     # (d, n)
    self.estimators_ = []
    for _ in range(self.n_estimators):
      neg = _neg_gradient(codes, raw, K)
      stage = []
      for k in range(T):
        yk = (codes == 1).astype(np.float64) if K == 2 else \
            (codes == k).astype(np.float64)
        tree, leaf_of = _build_tree(
            X32, order, self.max_depth, rs.randint(0, _RAND_R_MAX),
            np.ascontiguousarray(neg[:, k]))
        for leaf in np.unique(leaf_of):
          rows = leaf_of == leaf
          g = neg[rows, k]
          prob = yk[rows] - g
          num = g.mean()
          if K > 2:
            num *= (K - 1) / K
          den = (prob * (1 - prob)).mean()
          tree.value[leaf] = 0.0 if abs(den) < 1e-150 else \
              float(num) / float(den)
        raw[:, k] += _LEARNING_RATE * np.asarray(tree.value)[leaf_of]
        stage.append(tree)
      self.estimators_.append(stage)
    return self

  @property
  def feature_importances_(self) -> np.ndarray:
    """Mean of the unnormalised importances of the trees with a split,
    normalised to sum 1 (sklearn's rule)."""
    trees = [t for stage in self.estimators_ for t in stage
             if t.node_count > 1]
    if not trees:
      return np.zeros(self.n_features_in_)
    avg = np.mean([t.importances(self.n_features_in_) for t in trees],
                  axis=0, dtype=np.float64)
    return avg / avg.sum()

  def decision_function(self, X) -> np.ndarray:
    X32 = self._host32(X)
    raw = np.tile(self._init, (len(X32), 1))
    for stage in self.estimators_:
      for k, tree in enumerate(stage):
        raw[:, k] += _LEARNING_RATE * np.asarray(tree.value)[
            tree.apply(X32)]
    return raw[:, 0] if raw.shape[1] == 1 else raw

  def predict(self, X) -> np.ndarray:
    raw = self.decision_function(X)
    idx = (raw >= 0).astype(int) if raw.ndim == 1 else raw.argmax(1)
    return self.classes_[idx]

  def score(self, X, y) -> float:
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
    return float(np.mean(self.predict(X) == np.asarray(y).ravel()))


class RandomForestRegressor:
  """sklearn's ``RandomForestRegressor(n_estimators, max_depth,
  random_state)`` at its other defaults: squared error, every feature a
  split, bootstrap. Each tree draws its seed from the forest's
  ``RandomState`` (``randint(2**31 - 1)``), its bootstrap from a
  ``RandomState`` of that seed (``randint(0, n, n)``, counted into sample
  weights) and its feature order from one ``randint(0, 2**31 - 1)`` of
  another, as sklearn's tree does; the tree is grown on the host by
  ``_TreeBuilder`` at those weights. ``feature_importances_`` is
  sklearn's: each tree's weighted impurity decrease normalized, averaged
  over the trees with a split, normalized."""

  def __init__(self, n_estimators: int = 100, max_depth: Optional[int] =
               None, random_state=None):
    self.n_estimators = int(n_estimators)
    self.max_depth = max_depth
    self.random_state = random_state

  def fit(self, X, y) -> "RandomForestRegressor":
    X32 = GradientBoostingClassifier._host32(X)
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
    y = np.ascontiguousarray(np.asarray(y, np.float64).ravel())
    n, d = X32.shape
    self.n_features_in_ = d
    depth = np.iinfo(np.int32).max if self.max_depth is None \
        else int(self.max_depth)
    rs = check_random_state(self.random_state)
    seeds = [rs.randint(np.iinfo(np.int32).max)
             for _ in range(self.n_estimators)]
    order = np.argsort(X32, axis=0, kind="stable").T.copy()     # (d, n)
    self.estimators_ = []
    for seed in seeds:
      counts = np.bincount(np.random.RandomState(seed).randint(0, n, n),
                           minlength=n).astype(np.float64)
      split_seed = np.random.RandomState(seed).randint(0, _RAND_R_MAX)
      tree, _ = _build_tree(X32, order, depth, split_seed, y,
                            weights=counts)
      self.estimators_.append(tree)
    return self

  @property
  def feature_importances_(self) -> np.ndarray:
    per_tree = []
    for t in self.estimators_:
      if t.node_count <= 1:
        continue
      imp = t.importances(self.n_features_in_)
      total = imp.sum()
      per_tree.append(imp / total if total > 0.0 else imp)
    if not per_tree:
      return np.zeros(self.n_features_in_)
    avg = np.mean(per_tree, axis=0, dtype=np.float64)
    return avg / np.sum(avg)

  def predict(self, X) -> np.ndarray:
    X32 = GradientBoostingClassifier._host32(X)
    out = np.zeros(len(X32))
    for t in self.estimators_:
      out += np.asarray(t.value)[t.apply(X32)]
    return out / len(self.estimators_)


def _exp(a: np.ndarray) -> np.ndarray:
  """The C library's ``exp`` element by element, as sklearn's Cython loss
  calls it (numpy's vectorised ``exp`` may differ in the last bit)."""
  return np.fromiter(map(math.exp, a.ravel().tolist()), np.float64,
                     a.size).reshape(a.shape)


def _neg_gradient(codes: np.ndarray, raw: np.ndarray, K: int) -> np.ndarray:
  """The log-loss's negative gradient in sklearn's arithmetic
  (``_loss.pyx``): the binomial's two branches at raw −37; the
  multinomial's softmax with the row max subtracted and its exponentials
  summed in class order."""
  if K == 2:
    y, r = codes.astype(np.float64), raw[:, 0]
    low = r <= -37
    e = _exp(np.where(low, r, -r))
    g = np.where(low, e - y, ((1 - y) - y * e) / (1 + e))
    return -g[:, None]
  p = _exp(raw - raw.max(1, keepdims=True))
  s = np.zeros(len(p))
  for k in range(K):
    s += p[:, k]
  return -(p / s[:, None] - (codes[:, None] == np.arange(K)))

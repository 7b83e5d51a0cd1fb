"""The port's counterparts of sklearn's decompositions: PCA and
IncrementalPCA, which the JAX data analyzer fits
(``sisua_tpu/data/analysis.py::dimension_reduce``), and FactorAnalysis,
NMF and SparsePCA, which the JAX baselines fit (``sisua_tpu/baselines.py``),
with ``randomized_svd`` and ``sparse_encode``.

Each follows sklearn 1.9 step by step, in its dtypes, as torch operations
on ``device`` (default ``'cuda'``, which must exist; ``'cpu'`` on
request); only sparse coding's LARS paths run on the host
(``analysis/lars.py``):

  * ``PCA`` picks sklearn's solver by shape (``svd_solver='auto'``):
    'covariance_eigh' when there are at most 1,000 features and ten times
    as many rows, else 'full' when neither side exceeds 500, else
    'randomized' when ``n_components`` < 0.8·min(shape), else 'full'.
    'full' is the thin SVD of the centred data; 'covariance_eigh' the
    eigendecomposition of the covariance built from XᵀX; 'randomized'
    Halko's range finder with sklearn's draws (one ``normal`` matrix from
    ``RandomState(random_state)``, ``n_components`` + 10 columns, 7 power
    iterations below a tenth of min(shape) else 4, LU-normalized, a final
    QR, the data transposed when it is wider than tall). Signs follow
    ``svd_flip(u_based_decision=False)``: each component's largest
    |entry| is positive.
  * ``IncrementalPCA`` runs ``partial_fit`` over sklearn's batches
    (``gen_batches`` with ``min_batch_size=n_components``): running
    float64 means, each batch's SVD stacked on the previous components
    and the mean correction, so the second batch on computes in float64
    as sklearn's ``vstack`` promotes it;
  * ``FactorAnalysis``, ``NMF`` ('cd') and ``SparsePCA`` ('lars'): see
    each class.

A float32 input stays float32 where sklearn keeps it so; everything else
is float64. The decompositions are LAPACK's on the CPU and cuSOLVER's on
the card: the subspaces agree to rounding, and a component whose singular
value is nearly tied with a neighbour's may rotate within their plane.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .estimators import _float_matrix, _resolve, check_random_state
from .stats import divide

__all__ = ["PCA", "IncrementalPCA", "FactorAnalysis", "NMF", "SparsePCA",
           "randomized_svd", "sparse_encode", "svd_flip"]


def svd_flip(u: Optional[torch.Tensor], v: Optional[torch.Tensor],
             u_based_decision: bool = True):
  """sklearn's ``svd_flip``: each column of ``u`` and row of ``v`` signed so
  that the largest |entry| of ``u``'s column (``u_based_decision``) or of
  ``v``'s row is positive."""
  if u_based_decision:
    idx = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u.gather(0, idx[None, :]))[0]
  else:
    idx = torch.argmax(torch.abs(v), dim=1)
    signs = torch.sign(v.gather(1, idx[:, None]))[:, 0]
  if u is not None:
    u = u * signs[None, :]
  if v is not None:
    v = v * signs[:, None]
  return u, v


def _lu_normalized(A: torch.Tensor) -> torch.Tensor:
  """scipy's ``lu(A, permute_l=True)[0]``: P·L."""
  P, L, _ = torch.linalg.lu(A)
  return P @ L


def randomized_svd(M: torch.Tensor, n_components: int, *,
                   n_oversamples: int = 10, n_iter="auto",
                   power_iteration_normalizer: str = "auto",
                   transpose="auto", flip_sign: bool = True,
                   random_state=None) -> tuple:
  """sklearn's ``randomized_svd`` of the tensor ``M``, on its device and in
  its dtype: ``n_components`` + ``n_oversamples`` Gaussian columns drawn
  from ``random_state`` (a numpy ``RandomState`` or a seed) on the host,
  ``n_iter`` power iterations ('auto': 7 below a tenth of min(shape), else
  4) normalized by LU ('auto': none for ``n_iter`` ≤ 2, else 'LU'; 'QR'
  and 'none' on request), a final QR, ``M`` transposed when it is wider
  than tall ('auto'), and signs by ``svd_flip`` (u-based) unless
  ``flip_sign`` is False."""
  rs = check_random_state(random_state)
  n_random = n_components + n_oversamples
  n_samples, n_features = M.shape
  if n_iter == "auto":
    n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
  if transpose == "auto":
    transpose = n_samples < n_features
  if transpose:
    M = M.T
  Q = rs.normal(size=(M.shape[1], n_random))
  Q = torch.as_tensor(Q.astype(np.float32) if M.dtype == torch.float32
                      else Q, device=M.device)
  normalizer = power_iteration_normalizer
  if normalizer == "auto":
    normalizer = "none" if n_iter <= 2 else "LU"
  if normalizer not in ("LU", "QR", "none"):
    raise ValueError(f"power_iteration_normalizer={normalizer!r}")
  for _ in range(n_iter):
    if normalizer == "LU":
      Q = _lu_normalized(M @ Q)
      Q = _lu_normalized(M.T @ Q)
    elif normalizer == "QR":
      Q = torch.linalg.qr(M @ Q, mode="reduced")[0]
      Q = torch.linalg.qr(M.T @ Q, mode="reduced")[0]
    else:
      Q = M.T @ (M @ Q)
  Q, _ = torch.linalg.qr(M @ Q, mode="reduced")
  Uhat, s, Vt = torch.linalg.svd(Q.T @ M, full_matrices=False)
  U = Q @ Uhat
  if flip_sign:
    U, Vt = svd_flip(U, Vt, u_based_decision=not transpose)
  if transpose:
    return Vt[:n_components].T, s[:n_components], U[:, :n_components].T
  return U[:, :n_components], s[:n_components], Vt[:n_components]


class PCA:
  """sklearn's ``PCA(n_components, svd_solver, random_state)`` (see the
  module docstring; ``svd_solver`` 'auto' picks by shape, 'full',
  'covariance_eigh' or 'randomized' on request); ``components_``,
  ``mean_``, ``explained_variance_``, ``explained_variance_ratio_`` and
  ``singular_values_`` as tensors on ``device``, and ``svd_solver_``
  (the solver used)."""

  def __init__(self, n_components: Optional[int] = None, svd_solver="auto",
               random_state=None, device="cuda"):
    if svd_solver not in ("auto", "full", "covariance_eigh", "randomized"):
      raise ValueError(f"svd_solver={svd_solver!r}")
    self.n_components = n_components
    self.svd_solver = svd_solver
    self.random_state = random_state
    self.device = device

  def _solver(self, n: int, d: int, k: int) -> str:
    if self.svd_solver != "auto":
      return self.svd_solver
    if d <= 1000 and n >= 10 * d:
      return "covariance_eigh"
    if max(n, d) <= 500:
      return "full"
    if 1 <= k < 0.8 * min(n, d):
      return "randomized"
    return "full"

  def _fit(self, X: torch.Tensor):
    n, d = X.shape
    k = min(n, d) if self.n_components is None else int(self.n_components)
    if not 1 <= k <= min(n, d):
      raise ValueError(f"n_components={k} must be between 1 and "
                       f"min(n_samples, n_features)={min(n, d)}")
    self.svd_solver_ = solver = self._solver(n, d, k)
    self.mean_ = X.mean(0)
    U = None
    if solver == "full":
      Xc = X - self.mean_
      U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
      var = S * S / (n - 1)
      U, Vt = svd_flip(U, Vt, u_based_decision=False)
    elif solver == "covariance_eigh":
      C = X.T @ X
      C -= n * self.mean_[:, None] * self.mean_[None, :]
      C /= n - 1
      vals, vecs = torch.linalg.eigh(C)
      vals, vecs = torch.flip(vals, (0,)), torch.flip(vecs, (1,))
      vals = torch.where(vals < 0.0, torch.zeros_like(vals), vals)
      var = vals
      S = torch.sqrt(vals * (n - 1))
      _, Vt = svd_flip(None, vecs.T, u_based_decision=False)
    else:
      Xc = X - self.mean_
      U, S, Vt = randomized_svd(Xc, k, flip_sign=False,
                                random_state=self.random_state)
      U, Vt = svd_flip(U, Vt, u_based_decision=False)
      var = S * S / (n - 1)
      total = torch.sum(Xc * Xc) / (n - 1)
    if solver != "randomized":
      total = torch.sum(var)
    self.n_components_ = k
    self.components_ = Vt[:k].contiguous()
    self.explained_variance_ = var[:k]
    self.explained_variance_ratio_ = var[:k] / total
    self.singular_values_ = S[:k]
    return U, S

  def fit(self, X, y=None) -> "PCA":
    self._fit(_float_matrix(X, _resolve(self.device)))
    return self

  def fit_transform(self, X, y=None) -> torch.Tensor:
    X = _float_matrix(X, _resolve(self.device))
    U, S = self._fit(X)
    if U is None:   # covariance_eigh has no U: project the data
      return self._transform(X)
    return U[:, :self.n_components_] * S[:self.n_components_]

  def _transform(self, X: torch.Tensor) -> torch.Tensor:
    out = X @ self.components_.T
    return out - self.mean_[None, :] @ self.components_.T

  def transform(self, X) -> torch.Tensor:
    return self._transform(_float_matrix(X, _resolve(self.device)))


def _gen_batches(n: int, batch_size: int, min_batch_size: int):
  """sklearn's ``gen_batches``: a short last batch joins the one before."""
  start = 0
  for _ in range(n // batch_size):
    end = start + batch_size
    if end + min_batch_size > n:
      continue
    yield slice(start, end)
    start = end
  if start < n:
    yield slice(start, n)


class IncrementalPCA:
  """sklearn's ``IncrementalPCA(n_components, batch_size)`` (see the
  module docstring): ``fit`` runs ``partial_fit`` over the batches;
  ``transform`` projects in float64 where the components are."""

  def __init__(self, n_components: Optional[int] = None,
               batch_size: Optional[int] = None, device="cuda"):
    self.n_components = n_components
    self.batch_size = batch_size
    self.device = device

  def fit(self, X, y=None) -> "IncrementalPCA":
    X = _float_matrix(X, _resolve(self.device))
    n, d = X.shape
    self.batch_size_ = 5 * d if self.batch_size is None else self.batch_size
    self.n_samples_seen_ = 0
    for batch in _gen_batches(n, self.batch_size_, self.n_components or 0):
      self.partial_fit(X[batch])
    return self

  def partial_fit(self, X, y=None) -> "IncrementalPCA":
    X = _float_matrix(X, _resolve(self.device))
    n, d = X.shape
    first = getattr(self, "n_samples_seen_", 0) == 0
    if self.n_components is None:
      k = min(n, d) if first else self.components_.shape[0]
    else:
      k = int(self.n_components)
      if k > d or (first and k > n):
        raise ValueError(f"n_components={k} invalid for a batch of "
                         f"shape {(n, d)}")
    self.n_components_ = k
    X64 = X.to(torch.float64)
    new_sum = X64.sum(0)
    seen = self.n_samples_seen_
    total = seen + n
    if first:
      mean = new_sum / total
      t = X64 - new_sum / n
      var = (torch.sum(t * t, 0) - torch.sum(t, 0) ** 2 / n) / total
      Xc = (X64 - mean).to(X.dtype)
    else:
      last_sum = self.mean_ * seen
      mean = (last_sum + new_sum) / total
      t = X64 - new_sum / n
      new_unnorm = torch.sum(t * t, 0) - torch.sum(t, 0) ** 2 / n
      ratio = seen / n
      unnorm = (self.var_ * seen + new_unnorm
                + ratio / total * (last_sum / ratio - new_sum) ** 2)
      var = unnorm / total
      batch_mean = X64.mean(0).to(X.dtype)
      correction = np.sqrt((seen / total) * n) * (
          self.mean_ - batch_mean.to(torch.float64))
      # sklearn's vstack: the float64 mean correction promotes the stack
      Xc = torch.cat([
          (self.singular_values_[:, None] * self.components_).to(
              torch.float64),
          (X - batch_mean).to(torch.float64), correction[None, :]])
    U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    U, Vt = svd_flip(U, Vt, u_based_decision=False)
    self.n_samples_seen_ = total
    self.components_ = Vt[:k].contiguous()
    self.singular_values_ = S[:k]
    self.mean_ = mean
    self.var_ = var
    self.explained_variance_ = (S * S / (total - 1))[:k]
    self.explained_variance_ratio_ = (S * S / torch.sum(var * total))[:k]
    return self

  def transform(self, X) -> torch.Tensor:
    X = _float_matrix(X, _resolve(self.device))
    comp = self.components_
    dtype = torch.promote_types(X.dtype, comp.dtype)
    out = X.to(dtype) @ comp.T.to(dtype)
    return out - self.mean_[None, :].to(dtype) @ comp.T.to(dtype)

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)


def _squared_norm(x: torch.Tensor) -> torch.Tensor:
  """sklearn's ``squared_norm``: the dot product of the flattened array
  with itself."""
  x = x.reshape(-1)
  return torch.dot(x, x)


class FactorAnalysis:
  """sklearn's ``FactorAnalysis(n_components, tol, max_iter,
  iterated_power, random_state)`` with its default 'randomized' SVD: the
  SVD-based EM of Barber's 21.2.33, in float64 whatever the input (as
  sklearn validates it). Each iteration takes ``randomized_svd``
  (``iterated_power`` LU power iterations) of the noise-whitened data,
  every draw from the one ``RandomState`` that ``fit`` makes, in
  sklearn's order. It stops when the log-likelihood gains less than
  ``tol``. ``components_``, ``noise_variance_``, ``mean_`` on ``device``;
  ``loglike_`` and ``n_iter_`` on the host."""

  def __init__(self, n_components: Optional[int] = None, *,
               tol: float = 1e-2, max_iter: int = 1000,
               iterated_power: int = 3, random_state=0, device="cuda"):
    self.n_components = n_components
    self.tol = tol
    self.max_iter = max_iter
    self.iterated_power = iterated_power
    self.random_state = random_state
    self.device = device

  def fit(self, X, y=None) -> "FactorAnalysis":
    X = _float_matrix(X, _resolve(self.device)).to(torch.float64)
    n, d = X.shape
    k = d if self.n_components is None else int(self.n_components)
    self.mean_ = X.mean(0)
    X = X - self.mean_
    nsqrt = math.sqrt(n)
    llconst = d * math.log(2.0 * np.pi) + k
    var = X.var(0, unbiased=False)
    psi = torch.ones(d, dtype=X.dtype, device=X.device)
    small = 1e-12
    rs = check_random_state(self.random_state)

    loglike = []
    old_ll = -np.inf
    for i in range(self.max_iter):
      sqrt_psi = torch.sqrt(psi) + small
      Y = X / (sqrt_psi * nsqrt)
      _, s, Vt = randomized_svd(Y, k, n_iter=self.iterated_power,
                                random_state=rs)
      unexp_var = _squared_norm(Y) - _squared_norm(s)
      s = s ** 2
      W = torch.sqrt(torch.clamp(s - 1.0, min=0.0))[:, None] * Vt
      W = W * sqrt_psi
      ll = llconst + torch.sum(torch.log(s))
      ll = ll + unexp_var + torch.sum(torch.log(psi))
      ll = float(ll * (-n / 2.0))
      loglike.append(ll)
      if ll - old_ll < self.tol:
        break
      old_ll = ll
      psi = torch.clamp(var - torch.sum(W ** 2, 0), min=small)
    self.components_ = W
    self.noise_variance_ = psi
    self.loglike_ = loglike
    self.n_iter_ = i + 1
    return self

  def transform(self, X) -> torch.Tensor:
    """The latent means: (X − mean) Wᵀ Ψ⁻¹ (I + W Ψ⁻¹ Wᵀ)⁻¹."""
    X = _float_matrix(X, _resolve(self.device))
    W = self.components_
    Xt = X - self.mean_
    Wpsi = W / self.noise_variance_
    eye = torch.eye(len(W), dtype=W.dtype, device=W.device)
    cov_z = torch.linalg.inv(eye + Wpsi @ W.T)
    return (Xt @ Wpsi.T) @ cov_z

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)


# ------------------------------------------------------------------- NMF
def _initialize_nmf(X: torch.Tensor, k: int, random_state,
                    eps: float = 1e-6):
  """sklearn's ``_initialize_nmf`` ('nndsvda'): the signed parts of
  ``randomized_svd``'s pairs, in X's dtype (the norms and their products
  are Python floats, as sklearn's ``math.sqrt`` makes them), the zeros
  filled with X's mean."""
  U, S, V = randomized_svd(X, k, random_state=random_state)
  W = torch.zeros_like(U)
  H = torch.zeros_like(V)
  W[:, 0] = torch.sqrt(S[0]) * torch.abs(U[:, 0])
  H[0, :] = torch.sqrt(S[0]) * torch.abs(V[0, :])

  def norm(x):
    return math.sqrt(float(_squared_norm(x)))

  for j in range(1, k):
    x, y = U[:, j], V[j, :]
    x_p, y_p = torch.clamp(x, min=0), torch.clamp(y, min=0)
    x_n, y_n = torch.abs(torch.clamp(x, max=0)), torch.abs(
        torch.clamp(y, max=0))
    x_p_nrm, y_p_nrm = norm(x_p), norm(y_p)
    x_n_nrm, y_n_nrm = norm(x_n), norm(y_n)
    m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
    if m_p > m_n:
      u, v, sigma = divide(x_p, x_p_nrm), divide(y_p, y_p_nrm), m_p
    else:
      u, v, sigma = divide(x_n, x_n_nrm), divide(y_n, y_n_nrm), m_n
    # np.sqrt(S[j] * sigma): a Python float takes S's dtype
    lbd = torch.sqrt(S[j] * torch.tensor(sigma, dtype=S.dtype,
                                         device=S.device))
    W[:, j] = lbd * u
    H[j, :] = lbd * v
  W[W < eps] = 0
  H[H < eps] = 0
  avg = X.mean()
  W[W == 0] = avg
  H[H == 0] = avg
  return W, H


def _update_cdnmf(W: torch.Tensor, HHt: torch.Tensor,
                  XHt: torch.Tensor) -> torch.Tensor:
  """sklearn's ``_update_cdnmf_fast`` (no shuffle) on every row at once:
  the components in order, each row's gradient summed over the components
  in order in W's dtype, as the Cython loop does. The violation's row sum
  is the device's order (a rounding-level difference). Updates W in
  place; returns the violation as a 0-dim tensor."""
  k = W.shape[1]
  hess = HHt.diagonal().cpu().tolist()
  violation = torch.zeros((), dtype=W.dtype, device=W.device)
  for t in range(k):
    grad = -XHt[:, t]
    for r in range(k):
      grad = grad + HHt[t, r] * W[:, r]
    w = W[:, t]
    pg = torch.where(w == 0, torch.clamp(grad, max=0.0), grad)
    violation = violation + torch.sum(torch.abs(pg))
    if hess[t] != 0:
      W[:, t] = torch.clamp(w - grad / HHt[t, t], min=0.0)
  return violation


def _fit_coordinate_descent(X: torch.Tensor, W: torch.Tensor,
                            H: torch.Tensor, tol: float, max_iter: int,
                            update_H: bool = True):
  """sklearn's ``_fit_coordinate_descent`` without regularization or
  shuffling: W's sweep, then H's, until the violation falls to ``tol`` of
  the first sweep's."""
  W = W.contiguous()
  Ht = H.T.contiguous()
  violation_init = None
  for n_iter in range(1, max_iter + 1):
    # sklearn adds the sweeps' violations as Python floats
    violation = float(_update_cdnmf(W, Ht.T @ Ht, X @ Ht))
    if update_H:
      violation += float(_update_cdnmf(Ht, W.T @ W, X.T @ W))
    if n_iter == 1:
      violation_init = violation
    if violation_init == 0:
      break
    if violation / violation_init <= tol:
      break
  return W, Ht.T, n_iter


class NMF:
  """sklearn's ``NMF(n_components, init, tol, max_iter, random_state)``
  with its default solver: the Frobenius loss by coordinate descent
  ('cd', no regularization, no shuffling), initialized by 'nndsvda'
  (which ``init=None`` picks when n_components ≤ min(shape)).
  A sweep is sequential over the components and independent over rows:
  each row's update runs as one tensor operation on ``device``. A float32
  input stays float32. ``components_`` (H), ``reconstruction_err_``,
  ``n_iter_``; ``transform`` solves W with H fixed from zeros."""

  def __init__(self, n_components: Optional[int] = None, *, init=None,
               tol: float = 1e-4, max_iter: int = 200, random_state=None,
               device="cuda"):
    if init not in (None, "nndsvda"):
      raise ValueError(f"init={init!r} (None or 'nndsvda')")
    self.n_components = n_components
    self.init = init
    self.tol = tol
    self.max_iter = max_iter
    self.random_state = random_state
    self.device = device

  def _input(self, X) -> torch.Tensor:
    X = _float_matrix(X, _resolve(self.device))
    if bool(torch.any(X < 0)):
      raise ValueError("Negative values in data passed to NMF")
    return X

  def fit_transform(self, X, y=None) -> torch.Tensor:
    X = self._input(X)
    n, d = X.shape
    k = d if self.n_components in (None, "auto") else int(self.n_components)
    if k > min(n, d):
      raise ValueError("init='nndsvda' can only be used when n_components "
                       "<= min(n_samples, n_features)")
    W, H = _initialize_nmf(X, k, self.random_state)
    W, H, n_iter = _fit_coordinate_descent(X, W, H, self.tol, self.max_iter)
    self.reconstruction_err_ = float(torch.sqrt(_squared_norm(X - W @ H)))
    self.n_components_ = k
    self.components_ = H
    self.n_iter_ = n_iter
    return W

  def fit(self, X, y=None) -> "NMF":
    self.fit_transform(X)
    return self

  def transform(self, X) -> torch.Tensor:
    X = self._input(X)
    H = self.components_.to(X.dtype)
    W = torch.zeros((X.shape[0], H.shape[0]), dtype=X.dtype,
                    device=X.device)
    W, _, _ = _fit_coordinate_descent(X, W, H, self.tol, self.max_iter,
                                      update_H=False)
    return W


# ------------------------------------------------------------ SparsePCA
def sparse_encode(X: torch.Tensor, dictionary: torch.Tensor,
                  alpha: float = 1.0, max_iter: int = 1000,
                  num_threads: Optional[int] = None) -> torch.Tensor:
  """sklearn's ``sparse_encode(algorithm='lasso_lars')``: each row of X
  coded on the dictionary's atoms by the LARS-Lasso path at
  alpha / n_features, from the Gram of the atoms and their correlations
  with the rows (both on X's device), the paths on the host
  (``analysis/lars.py``). Returns the code on X's device."""
  from .lars import lasso_lars_gram
  gram = dictionary @ dictionary.T
  cov = dictionary @ X.T
  code = lasso_lars_gram(gram.cpu().numpy(), cov.T.cpu().numpy(),
                         n_samples=X.shape[1],
                         alpha_min=float(alpha) / X.shape[1],
                         max_iter=max_iter, num_threads=num_threads)
  return torch.as_tensor(code, device=X.device)


def _update_dict(dictionary: torch.Tensor, Y: torch.Tensor,
                 code: torch.Tensor, rs) -> None:
  """sklearn's ``_update_dict`` (in place): each atom in turn moved by its
  block-coordinate step, or, when almost unused (A[k, k] ≤ 1e-6), redrawn
  from a random row of Y plus 1% noise from ``rs``; then scaled into the
  unit ball."""
  n_samples, n_components = code.shape
  A = code.T @ code
  B = Y.T @ code
  used = (A.diagonal() > 1e-6).cpu().tolist()
  for k in range(n_components):
    if used[k]:
      dictionary[k] += (B[:, k] - A[k] @ dictionary) / A[k, k]
    else:
      newd = Y[rs.choice(n_samples)]
      std = newd.cpu().numpy().std()
      noise = rs.normal(0, 0.01 * (std or 1), size=len(newd))
      dictionary[k] = (newd.to(torch.float64) + torch.as_tensor(
          noise, device=newd.device)).to(dictionary.dtype)
      code[:, k] = 0
    nrm = torch.sqrt(torch.dot(dictionary[k], dictionary[k]))
    dictionary[k] /= torch.clamp(nrm, min=1.0)


def _dict_learning(X: torch.Tensor, n_components: int, alpha: float,
                   tol: float, max_iter: int, rs,
                   num_threads: Optional[int] = None):
  """sklearn's ``_dict_learning`` with 'lasso_lars' coding: the SVD start
  (u-based signs, the atoms scaled by the singular values), then coding
  and dictionary updates until the cost 0.5‖X − code·D‖² + α‖code‖₁
  drops by less than ``tol`` of itself (compared in X's dtype, as numpy
  does)."""
  code, S, dictionary = torch.linalg.svd(X, full_matrices=False)
  code, dictionary = svd_flip(code, dictionary)
  dictionary = S[:, None] * dictionary
  r = len(dictionary)
  if n_components <= r:
    code = code[:, :n_components]
    dictionary = dictionary[:n_components, :].contiguous()
  else:
    code = torch.cat([code, code.new_zeros(len(code), n_components - r)], 1)
    dictionary = torch.cat([dictionary, dictionary.new_zeros(
        n_components - r, dictionary.shape[1])])
  npdt = np.float32 if X.dtype == torch.float32 else np.float64
  errors = []
  ii = -1
  for ii in range(max_iter):
    code = sparse_encode(X, dictionary, alpha=alpha, num_threads=num_threads)
    _update_dict(dictionary, X, code, rs)
    fit = torch.sum((X - code @ dictionary) ** 2)
    l1 = torch.sum(torch.abs(code))
    cost = npdt(0.5) * npdt(float(fit)) + alpha * npdt(float(l1))
    errors.append(cost)
    if ii > 0 and errors[-2] - errors[-1] < tol * errors[-1]:
      break
  return code, dictionary, errors, ii + 1


class SparsePCA:
  """sklearn's ``SparsePCA(n_components, alpha, ridge_alpha, max_iter,
  tol, random_state)`` with its 'lars' method: dictionary learning on the
  centred data's transpose, so one LARS path per feature codes it
  (``sparse_encode``), then u-based signs and unit-norm components.
  Matrix products, the SVD start and the dictionary updates run on
  ``device``; the LARS paths on the host (``analysis/lars.py``, OpenMP
  over ``num_threads``). A float32 input stays float32. ``components_``,
  ``mean_``, ``error_``, ``n_iter_``; ``transform`` is the ridge
  regression (``solver='cholesky'``) of the centred data on the
  components."""

  def __init__(self, n_components: Optional[int] = None, *, alpha=1,
               ridge_alpha: float = 0.01, max_iter: int = 1000,
               tol: float = 1e-8, random_state=None, device="cuda",
               num_threads: Optional[int] = None):
    self.n_components = n_components
    self.alpha = alpha
    self.ridge_alpha = ridge_alpha
    self.max_iter = max_iter
    self.tol = tol
    self.random_state = random_state
    self.device = device
    self.num_threads = num_threads

  def fit(self, X, y=None) -> "SparsePCA":
    rs = check_random_state(self.random_state)
    X = _float_matrix(X, _resolve(self.device))
    self.mean_ = X.mean(0)
    X = X - self.mean_
    k = X.shape[1] if self.n_components is None else int(self.n_components)
    code, dictionary, E, self.n_iter_ = _dict_learning(
        X.T, k, self.alpha, self.tol, self.max_iter, rs, self.num_threads)
    code, dictionary = svd_flip(code, dictionary)
    comp = code.T
    norm = torch.sqrt(torch.sum(comp * comp, 1))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    self.components_ = (comp / norm[:, None]).contiguous()
    self.n_components_ = len(self.components_)
    self.error_ = E
    return self

  def transform(self, X) -> torch.Tensor:
    X = _float_matrix(X, _resolve(self.device)) - self.mean_
    C = self.components_.T.to(X.dtype)
    A = C.T @ C
    A.diagonal().add_(torch.tensor(self.ridge_alpha, dtype=X.dtype))
    Xy = C.T @ X.T
    return torch.cholesky_solve(Xy, torch.linalg.cholesky(A)).T

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)

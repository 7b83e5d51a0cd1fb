"""PCA and IncrementalPCA: the port's counterparts of sklearn's, which the
JAX data analyzer fits (``sisua_tpu/data/analysis.py::dimension_reduce``).

Both follow sklearn 1.9 step by step, in its dtypes, as torch operations
on ``device`` (default ``'cuda'``, which must exist; ``'cpu'`` on
request):

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
    as sklearn's ``vstack`` promotes it.

A float32 input stays float32 where sklearn keeps it so; everything else
is float64. The decompositions are LAPACK's on the CPU and cuSOLVER's on
the card: the subspaces agree to rounding, and a component whose singular
value is nearly tied with a neighbour's may rotate within their plane.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .estimators import _float_matrix, _resolve, check_random_state

__all__ = ["PCA", "IncrementalPCA", "svd_flip"]


def svd_flip(u: Optional[torch.Tensor], v: torch.Tensor):
  """sklearn's ``svd_flip(u_based_decision=False)``: each row of ``v``
  (and column of ``u``) signed so that its largest |entry| is positive."""
  idx = torch.argmax(torch.abs(v), dim=1)
  signs = torch.sign(v.gather(1, idx[:, None]))[:, 0]
  if u is not None:
    u = u * signs[None, :]
  return u, v * signs[:, None]


def _lu_normalized(A: torch.Tensor) -> torch.Tensor:
  """scipy's ``lu(A, permute_l=True)[0]``: P·L."""
  P, L, _ = torch.linalg.lu(A)
  return P @ L


def _randomized_svd(M: torch.Tensor, n_components: int,
                    random_state) -> tuple:
  """sklearn's ``_randomized_svd`` at PCA's settings (``n_oversamples``
  10, ``n_iter='auto'``, LU power iterations, ``flip_sign=False``)."""
  rs = check_random_state(random_state)
  n_random = n_components + 10
  n_samples, n_features = M.shape
  n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
  transpose = n_samples < n_features
  if transpose:
    M = M.T
  Q = rs.normal(size=(M.shape[1], n_random))
  Q = torch.as_tensor(Q.astype(np.float32) if M.dtype == torch.float32
                      else Q, device=M.device)
  for _ in range(n_iter):
    Q = _lu_normalized(M @ Q)
    Q = _lu_normalized(M.T @ Q)
  Q, _ = torch.linalg.qr(M @ Q, mode="reduced")
  Uhat, s, Vt = torch.linalg.svd(Q.T @ M, full_matrices=False)
  U = Q @ Uhat
  if transpose:
    return Vt[:n_components].T, s[:n_components], U[:, :n_components].T
  return U[:, :n_components], s[:n_components], Vt[:n_components]


class PCA:
  """sklearn's ``PCA(n_components, random_state)`` (see the module
  docstring); ``components_``, ``mean_``, ``explained_variance_``,
  ``explained_variance_ratio_``, ``singular_values_`` and
  ``svd_solver_`` (the solver 'auto' chose) as tensors on ``device``."""

  def __init__(self, n_components: Optional[int] = None, random_state=None,
               device="cuda"):
    self.n_components = n_components
    self.random_state = random_state
    self.device = device

  def _solver(self, n: int, d: int, k: int) -> str:
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
      U, Vt = svd_flip(U, Vt)
    elif solver == "covariance_eigh":
      C = X.T @ X
      C -= n * self.mean_[:, None] * self.mean_[None, :]
      C /= n - 1
      vals, vecs = torch.linalg.eigh(C)
      vals, vecs = torch.flip(vals, (0,)), torch.flip(vecs, (1,))
      vals = torch.where(vals < 0.0, torch.zeros_like(vals), vals)
      var = vals
      S = torch.sqrt(vals * (n - 1))
      _, Vt = svd_flip(None, vecs.T)
    else:
      Xc = X - self.mean_
      U, S, Vt = _randomized_svd(Xc, k, self.random_state)
      U, Vt = svd_flip(U, Vt)
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
    U, Vt = svd_flip(U, Vt)
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

"""t-SNE: the port's counterpart of sklearn 1.9's ``TSNE`` (Barnes-Hut,
its default), which the JAX package calls for ``dimension_reduce(algo=
'tsne')`` and ``utils.dimension_reduction('tsne')``, and sklearn's
``trustworthiness``.

``TSNE`` follows sklearn step by step:

  * neighbours, on ``device``: k = min(n − 1, ⌊3·perplexity + 1⌋) of
    every point but itself. sklearn's ``NearestNeighbors`` searches by
    brute force above 15 features (or when k ≥ n // 2), ranking by
    ‖x‖² + (−2x·y) + ‖y‖² in float64 (that rounding kept), else with a
    kd-tree on exact distances Σ(x − y)²; the port computes the same
    quantity for each case. The distances go through sklearn's square
    root and square, then float32;
  * the conditional probabilities (``_binary_search_perplexity``), on
    ``device`` for every row at once: a float64 bisection on each row's
    precision, at most 100 steps, to an entropy within 1e-5 of
    log(perplexity), over the row's neighbours in column order (the
    kNN graph's ``sort_indices``); then P + Pᵀ and its normalization
    (``_joint_probabilities_nn``), summed duplicates as scipy sums them;
  * the start: ``PCA(n_components, random_state)`` of the data, in
    float32, scaled by 1e-4 / std(column 0), or an ``init`` array;
  * ``_gradient_descent``: 250 iterations at momentum 0.5 with P × 12,
    then momentum 0.8 to ``max_iter``; gains +0.2 / ×0.8, floored at
    0.01; the error checked every 50 iterations, stopping after
    ``n_iter_without_progress`` without progress or below
    ``min_grad_norm``. The update, gains and positions live on
    ``device``, in sklearn's dtypes (positions and gains float32; with
    ``learning_rate='auto'`` numpy's float64 rate makes the update
    float64).

The gradient is the host half: each iteration sends the positions (n ×
n_components float32) to the host, where ``native/tsne.cpp`` builds
sklearn's quadtree (2-D) or octree (3-D) and computes the Barnes-Hut
forces with OpenMP over ``num_threads`` (default: OpenMP's team, as
sklearn's), and the forces go back. At one thread they are sklearn's bit
for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .estimators import _float_matrix, _resolve, check_random_state

__all__ = ["TSNE", "trustworthiness"]

_EXPLORATION_MAX_ITER = 250
_N_ITER_CHECK = 50
_MACHINE_EPSILON = float(np.finfo(np.double).eps)
# _utils.pyx's constants are ``cdef float``
_EPSILON_DBL = float(np.float32(1e-8))
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
_KNN_BUDGET = 512 << 20   # bytes of one block of float64 distances


def _sq_distances(X: torch.Tensor, rows: slice, exact: bool) -> torch.Tensor:
  """float64 squared distances of ``X[rows]`` to every row: sklearn's
  brute force (‖x‖² + (−2x·y) + ‖y‖², clipped at 0) or its kd-tree's
  Σ(x − y)² over the features in order."""
  Q = X[rows]
  if exact:
    d = torch.zeros((Q.shape[0], X.shape[0]), dtype=X.dtype,
                    device=X.device)
    for f in range(X.shape[1]):
      diff = Q[:, f, None] - X[None, :, f]
      d = d + diff * diff
    return d
  sq = torch.sum(X * X, 1)
  d = (sq[rows, None] + (-2.0 * (Q @ X.T))) + sq[None, :]
  return torch.clamp(d, min=0.0)


def _kneighbors(X: torch.Tensor, k: int):
  """sklearn's ``NearestNeighbors(k).kneighbors()`` on its own data
  (itself left out): (indices (n, k), distances float64), nearest first.
  The brute force converts a float32 input's squared distances back to
  float32 before the square root (its ``EuclideanDistance32``); the
  kd-tree works in float64."""
  n, f = X.shape
  exact = not (f > 15 or k >= n // 2)   # the kd-tree sklearn picks
  rounded = X.dtype == torch.float32 and not exact
  X = X.to(torch.float64)
  step = max(1, _KNN_BUDGET // (8 * n))
  idx, dist = [], []
  for lo in range(0, n, step):
    rows = slice(lo, min(n, lo + step))
    d = _sq_distances(X, rows, exact)
    # k + 1 nearest, ties by index, then each row's own index removed
    vals, pos = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
    pos, order = torch.sort(pos, dim=1)
    vals = vals.gather(1, order)
    vals, order = torch.sort(vals, dim=1, stable=True)
    pos = pos.gather(1, order)
    me = torch.arange(rows.start, rows.stop, device=X.device)[:, None]
    keep = pos != me
    # a row whose own index is not among its k + 1 nearest (duplicates
    # ranked first) drops its first column, as sklearn does
    keep[:, 0] &= ~torch.all(keep, dim=1)
    idx.append(pos[keep].view(-1, k))
    dist.append(vals[keep].view(-1, k))
  d = torch.cat(dist)
  if rounded:
    d = torch.sqrt(d.to(torch.float32).to(torch.float64)).to(
        torch.float32).to(torch.float64)
  else:
    d = torch.sqrt(d)
  return torch.cat(idx), d


def _binary_search_perplexity(D: torch.Tensor,
                              perplexity: float) -> torch.Tensor:
  """sklearn's ``_binary_search_perplexity`` on every row at once: ``D``
  (n, k) float32 squared distances; returns the (n, k) float64
  conditional probabilities. A row stops at its step's P once its entropy
  is within tolerance; the others take the next precision."""
  D = D.to(torch.float64)
  n = D.shape[0]
  desired = math.log(float(np.float32(perplexity)))
  beta = torch.ones(n, dtype=torch.float64, device=D.device)
  beta_min = torch.full_like(beta, -math.inf)
  beta_max = torch.full_like(beta, math.inf)
  live = torch.ones(n, dtype=torch.bool, device=D.device)
  P = torch.zeros_like(D)
  for _ in range(100):
    Pl = torch.exp(-D * beta[:, None])
    sum_P = torch.sum(Pl, 1)
    sum_P = torch.where(sum_P == 0.0, torch.full_like(sum_P, _EPSILON_DBL),
                        sum_P)
    Pl = Pl / sum_P[:, None]
    entropy = torch.log(sum_P) + beta * torch.sum(D * Pl, 1)
    diff = entropy - desired
    P = torch.where(live[:, None], Pl, P)
    live = live & (torch.abs(diff) > _PERPLEXITY_TOLERANCE)
    up = live & (diff > 0.0)
    down = live & (diff <= 0.0)
    new_up = torch.where(beta_max == math.inf, beta * 2.0,
                         (beta + beta_max) / 2.0)
    new_down = torch.where(beta_min == -math.inf, beta / 2.0,
                           (beta + beta_min) / 2.0)
    beta_min = torch.where(up, beta, beta_min)
    beta_max = torch.where(down, beta, beta_max)
    beta = torch.where(up, new_up, torch.where(down, new_down, beta))
    if not bool(live.any()):
      break
  return P


def _joint_probabilities_nn(idx: torch.Tensor, dist: torch.Tensor,
                            perplexity: float):
  """sklearn's ``_joint_probabilities_nn`` of a kNN graph (indices (n, k)
  and float64 distances, as ``_kneighbors`` gives them), which t-SNE
  squares: the symmetric, normalized P as CSR (indptr, indices, data
  float64) on their device."""
  n, k = idx.shape
  d2 = dist ** 2
  idx, order = torch.sort(idx, dim=1)  # the graph's sort_indices
  cond = _binary_search_perplexity(d2.gather(1, order).to(torch.float32),
                                   perplexity)
  rows = torch.arange(n, device=idx.device).repeat_interleave(k)
  cols = idx.reshape(-1)
  vals = cond.reshape(-1)
  # P + Pᵀ: each (i, j) once, in row-major order, as scipy's CSR sum
  # (two values at most meet at a key, so the sum is exact in any order)
  key, inverse = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                              sorted=True, return_inverse=True)
  data = torch.zeros(len(key), dtype=vals.dtype, device=vals.device)
  data.index_add_(0, inverse, torch.cat([vals, vals]))
  ij = torch.stack([key // n, key % n])
  nz = data != 0.0                     # scipy drops explicit zeros
  ij, data = ij[:, nz], data[nz]
  data = data / torch.clamp(torch.sum(data), min=_MACHINE_EPSILON)
  indptr = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
  indptr[1:] = torch.cumsum(torch.bincount(ij[0], minlength=n), 0)
  return indptr, ij[1].contiguous(), data


class TSNE:
  """sklearn's ``TSNE`` (Barnes-Hut) with its defaults (see the module
  docstring). ``fit_transform`` returns ``embedding_`` as a float32
  tensor on ``device``; ``kl_divergence_``, ``n_iter_`` and
  ``learning_rate_`` as sklearn keeps them. ``random_state`` seeds the
  PCA start's draws (a numpy ``RandomState`` or a seed)."""

  def __init__(self, n_components: int = 2, *, perplexity: float = 30.0,
               early_exaggeration: float = 12.0, learning_rate="auto",
               max_iter: int = 1000, n_iter_without_progress: int = 300,
               min_grad_norm: float = 1e-7, init="pca", random_state=None,
               angle: float = 0.5, device="cuda",
               num_threads: Optional[int] = None):
    if n_components not in (2, 3):
      raise ValueError("'n_components' should be 2 or 3 for the "
                       "barnes_hut algorithm (a quadtree or an octree)")
    self.n_components = n_components
    self.perplexity = perplexity
    self.early_exaggeration = early_exaggeration
    self.learning_rate = learning_rate
    self.max_iter = max_iter
    self.n_iter_without_progress = n_iter_without_progress
    self.min_grad_norm = min_grad_norm
    self.init = init
    self.random_state = random_state
    self.angle = angle
    self.device = device
    self.num_threads = num_threads

  def _start(self, X: torch.Tensor, rs) -> torch.Tensor:
    if not isinstance(self.init, str):  # kept in its dtype, as sklearn
      return _float_matrix(self.init, X.device)
    if self.init != "pca":
      raise ValueError(f"init={self.init!r} ('pca' or an array)")
    from .decomposition import PCA
    emb = PCA(self.n_components, random_state=rs,
              device=X.device).fit_transform(X).to(torch.float32)
    c0 = emb[:, 0]
    std = torch.sqrt(torch.mean((c0 - torch.mean(c0)) ** 2))
    return emb / std * 1e-4

  def _gradient(self, p: torch.Tensor, csr, dof: int, compute_error: bool):
    from ..native import tsne_gradient
    val_P, neighbors, indptr = csr
    pos = p.view(-1, self.n_components).to(torch.float32).cpu().numpy()
    error, forces = tsne_gradient(val_P, pos, neighbors, indptr, self.angle,
                                  dof, compute_error, self.num_threads)
    grad = torch.from_numpy(forces).to(p.device).view(-1)
    return error, grad * (2.0 * (dof + 1.0) / dof)

  def _descent(self, p0, csr, dof, it, max_iter, momentum,
               n_iter_without_progress):
    """sklearn's ``_gradient_descent``; returns (p, error, i). The
    positions, update and gains start in the start's dtype (float32 but
    for a float64 ``init`` array); numpy's promotions are followed."""
    p = p0.clone()
    update = torch.zeros_like(p)
    gains = torch.ones_like(p)
    floor = torch.tensor(0.01, dtype=p.dtype, device=p.device)
    lr = self.learning_rate_
    rate64 = self.learning_rate == "auto"
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
      check = (i + 1) % _N_ITER_CHECK == 0
      error, grad = self._gradient(p, csr, dof, check or i == max_iter - 1)
      inc = update * grad < 0.0
      gains = torch.maximum(torch.where(inc, gains + 0.2, gains * 0.8),
                            floor)
      grad = (grad * gains).to(torch.float32)   # numpy's ``grad *= gains``
      # numpy: the float64 'auto' rate makes the update float64
      update = momentum * update - (
          lr * grad.to(torch.float64) if rate64 else lr * grad)
      p = (p.to(update.dtype) + update).to(p.dtype)
      if check:
        grad_norm = float(torch.linalg.vector_norm(grad))
        if error < best_error:
          best_error, best_iter = error, i
        elif i - best_iter > n_iter_without_progress:
          break
        if grad_norm <= self.min_grad_norm:
          break
    return p, error, i

  def fit_transform(self, X, y=None) -> torch.Tensor:
    dev = _resolve(self.device)
    X = _float_matrix(X, dev).contiguous()   # one layout, one rounding
    n = X.shape[0]
    if self.perplexity >= n:
      raise ValueError(f"perplexity ({self.perplexity}) must be less than "
                       f"n_samples ({n})")
    if self.learning_rate == "auto":
      self.learning_rate_ = float(np.maximum(
          n / self.early_exaggeration / 4, 50))
    else:
      self.learning_rate_ = float(self.learning_rate)
    rs = check_random_state(self.random_state)
    k = min(n - 1, int(3.0 * self.perplexity + 1))
    indptr, indices, P = _joint_probabilities_nn(*_kneighbors(X, k),
                                                 self.perplexity)
    start = self._start(X, rs)
    dof = max(self.n_components - 1, 1)
    host = (indices.cpu().numpy(), indptr.cpu().numpy())
    P = P * self.early_exaggeration
    csr = (P.to(torch.float32).cpu().numpy(),) + host
    p, error, it = self._descent(start.reshape(-1), csr, dof, 0,
                                 _EXPLORATION_MAX_ITER, 0.5,
                                 _EXPLORATION_MAX_ITER)
    P = P / self.early_exaggeration
    if it < _EXPLORATION_MAX_ITER or self.max_iter > _EXPLORATION_MAX_ITER:
      csr = (P.to(torch.float32).cpu().numpy(),) + host
      p, error, it = self._descent(p, csr, dof, it + 1, self.max_iter, 0.8,
                                   self.n_iter_without_progress)
    self.n_iter_ = it
    self.kl_divergence_ = error
    self.embedding_ = p.view(n, self.n_components)
    return self.embedding_

  def fit(self, X, y=None) -> "TSNE":
    self.fit_transform(X)
    return self


def trustworthiness(X, X_embedded, *, n_neighbors: int = 5,
                    device="cuda") -> float:
  """sklearn's ``trustworthiness`` (Euclidean): how far the embedding's
  ``n_neighbors`` nearest points of each point rank beyond
  ``n_neighbors`` among its nearest in X, on ``device`` in blocks of
  rows. The ranks in X follow sklearn's brute-force distances; the
  embedding's neighbours its kd-tree's exact ones."""
  dev = _resolve(device)
  X = _float_matrix(X, dev).to(torch.float64)
  E = _float_matrix(X_embedded, dev).to(torch.float64)
  n, k = X.shape[0], int(n_neighbors)
  if k >= n / 2:
    raise ValueError(f"n_neighbors ({k}) should be less than n_samples / 2"
                     f" ({n / 2})")
  nn_emb, _ = _kneighbors(E, k)
  step = max(1, _KNN_BUDGET // (8 * n))
  t = 0
  for lo in range(0, n, step):
    rows = slice(lo, min(n, lo + step))
    d = torch.sqrt(_sq_distances(X, rows, exact=False))
    me = torch.arange(rows.start, rows.stop, device=dev)
    d[me - lo, me] = math.inf
    order = torch.argsort(d, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(1, n + 1, device=dev).expand_as(
        order).contiguous())
    r = rank.gather(1, nn_emb[rows]) - k
    t += int(torch.sum(torch.clamp(r, min=0)))
  return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))

"""UMAP (McInnes et al. 2018) as the JAX package computes it (port of
``sisua_tpu/data/umap_impl.py``), its heavy steps on the card:

  1. the kNN graph: the ``k + 1`` nearest rows of every row (itself
     first) by exact Euclidean distance in float64 on ``device``
     (``analysis.cluster.kneighbors``);
  2. the smooth-kNN calibration, every row at once on ``device``: ρ (the
     distance to the nearest other row) and σ by the JAX bisection, so the
     effective connectivity is log2(k + 1);
  3. the fuzzy simplicial set ``W + Wᵀ − W∘Wᵀ`` of the membership
     strengths, assembled with scipy on the host (its edge order is the
     SGD's);
  4. the spectral initialization: the symmetric normalized Laplacian's
     eigenvectors by scipy's ``eigsh`` on the host, with the JAX ``v0``
     and jitter draws, its shift-invert solves against a dense float64
     LU made once on ``device`` (up to 16,384 rows; beyond, scipy's sparse
     LU on the host, as the JAX package);
  5. the SGD of the cross-entropy layout: each epoch's edge draws and
     negative samples come from the JAX ``RandomState`` stream on the
     host (one upload an epoch), and the updates run on ``device`` in
     float32, as numpy runs
     them, as scatter-adds (``index_put_(accumulate=True)``: on the card
     it sorts the indices stably and adds each row's updates in their
     order, so two runs give the same bits; on the CPU it adds in order,
     as ``np.add.at``).

The JAX package's kNN comes from sklearn's brute search, which ranks by
‖x‖² − 2x·y + ‖y‖²: its distances carry rounding of order 1e-7 of ‖x‖²,
and a row's distance to itself is often such a rounding rather than 0,
in which case the JAX ρ of that row is that rounding. Here every distance
is exact, so a row's own distance is 0 and ρ is the nearest other row's.
numpy's float32 power is its own (SIMD, not correctly rounded) and
torch's differs in the last bit, and the layout's first epochs amplify
such differences: the layouts drift apart by rounding over the epochs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import sparse

__all__ = ["fit_umap", "fuzzy_simplicial_set", "find_ab_params"]

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def _device(device) -> torch.device:
  from ..models.base import resolve_device
  return resolve_device(device)


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
  """Fit the attraction curve 1/(1 + a·d^(2b)) to the target membership
  curve (1 below ``min_dist``, exp(−(d − min_dist)/spread) beyond)."""
  from scipy.optimize import curve_fit

  def curve(x, a, b):
    return 1.0 / (1.0 + a * x ** (2 * b))

  xv = np.linspace(0, spread * 3, 300)
  yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
  (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=10000)
  return float(a), float(b)


def _smooth_knn_dist(dists: torch.Tensor, k: float, n_iter: int = 64,
                     local_connectivity: float = 1.0):
  """Per-row (ρ, σ) of the (n, k) neighbour distances (float64): ρ the
  ``local_connectivity``-th positive distance, σ solving
  Σ_{j ≥ 1} exp(−max(0, d_j − ρ)/σ) = log2(k) by the JAX bisection, run
  for every row at once (a row stops where the JAX loop breaks)."""
  n = dists.shape[0]
  target = math.log2(k)
  pos = dists > 0.0
  n_pos = pos.sum(1)
  big = torch.where(pos, dists, torch.full_like(dists, math.inf))
  rank = int(math.ceil(local_connectivity)) - 1
  nth = torch.sort(big, dim=1).values[:, min(rank, dists.shape[1] - 1)]
  top = torch.where(pos, dists, torch.zeros_like(dists)).max(1).values
  rho = torch.where(n_pos >= local_connectivity, nth,
                    torch.where(n_pos > 0, top, torch.zeros_like(top)))
  lo = torch.zeros(n, dtype=dists.dtype, device=dists.device)
  hi = torch.full_like(lo, math.inf)
  mid = torch.ones_like(lo)
  live = torch.ones(n, dtype=torch.bool, device=dists.device)
  shifted = torch.clamp_min(dists - rho[:, None], 0.0)
  for _ in range(n_iter):
    psum = torch.exp(-shifted / mid[:, None])[:, 1:].sum(1)
    live = live & ~(torch.abs(psum - target) < SMOOTH_K_TOLERANCE)
    above = live & (psum > target)
    below = live & ~(psum > target)
    hi = torch.where(above, mid, hi)
    lo = torch.where(below, mid, lo)
    mid = torch.where(above, (lo + hi) / 2.0, torch.where(
        below, torch.where(torch.isinf(hi), mid * 2.0, (lo + hi) / 2.0),
        mid))
  mean_all = float(dists.mean()) or 1.0
  mean_i = dists.mean(1)
  mean_i = torch.where(mean_i == 0, torch.full_like(mean_i, mean_all), mean_i)
  sigma = torch.where(rho > 0.0,
                      torch.maximum(mid, MIN_K_DIST_SCALE * mean_i),
                      torch.clamp_min(mid, MIN_K_DIST_SCALE * mean_all))
  return rho, sigma


def fuzzy_simplicial_set(X, n_neighbors: int = 15, random_state: int = 8,
                         device="cuda") -> sparse.coo_matrix:
  """Directed kNN membership strengths → the symmetric fuzzy graph."""
  from ..analysis.cluster import kneighbors
  dev = _device(device)
  X = torch.as_tensor(np.asarray(X, np.float64), device=dev)
  n = X.shape[0]
  k = min(n_neighbors, n - 1)
  dists, idx = kneighbors(X, k + 1, device=dev)
  rho, sigma = _smooth_knn_dist(dists, k=float(k + 1))
  w = torch.exp(-torch.clamp_min(dists - rho[:, None], 0.0)
                / sigma[:, None])
  w[:, 0] = 0.0  # self-edge
  w, idx = w.cpu().numpy(), idx.cpu().numpy()
  rows = np.repeat(np.arange(n), idx.shape[1])
  A = sparse.coo_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n))
  A = A.tocsr()
  A.eliminate_zeros()
  T = A.multiply(A.T)
  W = A + A.T - T  # probabilistic t-conorm
  return W.tocoo()


_DENSE_INIT_BYTES = 2 << 30   # the Laplacian dense on the device up to this


def _shift_invert(L: sparse.spmatrix, device) -> "LinearOperator":
  """(L − 0·I)⁻¹ for ARPACK's shift-invert mode: a float64 LU of the dense
  Laplacian made once on ``device`` and solved there (scipy's sparse LU
  of the same matrix on the host fills in to near-dense at kNN-graph
  sizes); raises, as scipy's, on an exactly singular factor."""
  from scipy.sparse.linalg import LinearOperator
  n = L.shape[0]
  dense = torch.as_tensor(L.toarray(), device=device)
  lu, piv, info = torch.linalg.lu_factor_ex(dense)
  del dense
  if int(info) > 0:
    raise RuntimeError("Factor is exactly singular")

  def solve(v):
    b = torch.as_tensor(np.asarray(v, np.float64).reshape(n, -1),
                        device=device)
    return torch.linalg.lu_solve(lu, piv, b).cpu().numpy().reshape(v.shape)
  return LinearOperator((n, n), matvec=solve, dtype=np.float64)


def _spectral_init(W: sparse.spmatrix, n_components: int,
                   random_state: int, device="cpu") -> np.ndarray:
  """Eigenvectors of the symmetric normalized Laplacian (the trivial one
  skipped), scaled into a ±10 box, with the JAX draws: ARPACK's
  shift-invert at σ = 0 with the JAX ``v0``, its solves against a dense LU
  on ``device`` while the Laplacian fits ``_DENSE_INIT_BYTES``, else
  scipy's sparse LU on the host (the JAX package's)."""
  from scipy.sparse.linalg import eigsh
  n = W.shape[0]
  deg = np.asarray(W.sum(1)).ravel()
  dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
  L = sparse.identity(n) - sparse.diags(dinv) @ W @ sparse.diags(dinv)
  L = L.tocsc().astype(np.float64)
  rng = np.random.RandomState(random_state)
  try:
    k = n_components + 1
    v0 = rng.uniform(-1, 1, n)
    kw = {}
    if 8 * n * n <= _DENSE_INIT_BYTES:
      kw["OPinv"] = _shift_invert(L, device)
    vals, vecs = eigsh(L, k=k, sigma=0.0, which="LM", v0=v0,
                       maxiter=max(2000, 5 * n), **kw)
    order = np.argsort(vals)
    emb = vecs[:, order[1:k]]
  except Exception:  # Lanczos non-convergence on degenerate graphs
    emb = rng.uniform(-1, 1, (n, n_components))
  expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
  emb = emb * expansion
  return (emb + rng.normal(0, 1e-4, emb.shape)).astype(np.float32)


def fit_umap(X,
             n_components: int = 2,
             n_neighbors: int = 15,
             min_dist: float = 0.1,
             spread: float = 1.0,
             n_epochs: int = 0,
             negative_sample_rate: int = 5,
             learning_rate: float = 1.0,
             random_state: int = 8,
             device="cuda") -> np.ndarray:
  """UMAP embedding of X: (n, n_components) float32. ``n_epochs=0`` picks
  umap-learn's default (500 below 10k rows, else 200)."""
  dev = _device(device)
  X = np.asarray(X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
                 else X, np.float64)
  n = X.shape[0]
  if n <= n_components + 1:
    return np.zeros((n, n_components), np.float32)
  if not n_epochs:
    n_epochs = 500 if n < 10000 else 200
  W = fuzzy_simplicial_set(X, n_neighbors=n_neighbors,
                           random_state=random_state, device=dev)
  keep = W.data >= W.data.max() / float(n_epochs)
  heads = torch.as_tensor(W.row[keep].astype(np.int64), device=dev)
  tails = torch.as_tensor(W.col[keep].astype(np.int64), device=dev)
  weights = W.data[keep]
  y = torch.as_tensor(_spectral_init(W.tocsr(), n_components, random_state,
                                    dev), device=dev)
  a, b = find_ab_params(spread, min_dist)
  p_edge = weights / weights.max()
  rng = np.random.RandomState(random_state)
  for epoch in range(n_epochs):
    alpha = learning_rate * (1.0 - epoch / float(n_epochs))
    sel = np.flatnonzero(rng.random_sample(len(p_edge)) < p_edge)
    if not len(sel):
      continue
    # the epoch's edges and negative samples in one upload
    draws = [sel] + [rng.randint(0, n, len(sel))
                     for _ in range(negative_sample_rate)]
    draws = torch.as_tensor(np.concatenate(draws), device=dev).view(
        len(draws), -1)
    h, t = heads[draws[0]], tails[draws[0]]
    # attraction along the sampled edges
    d = y[h] - y[t]
    dsq = (d * d).sum(1)
    coeff = (-2.0 * a * b * dsq ** (b - 1.0)) / (a * dsq ** b + 1.0)
    coeff = torch.where(dsq <= 0.0, torch.zeros_like(coeff), coeff)
    g = torch.clamp(coeff[:, None] * d, -4.0, 4.0) * alpha
    y.index_put_((h,), g, accumulate=True)
    y.index_put_((t,), -g, accumulate=True)
    # repulsion against the sampled negatives (the head side only)
    for neg in draws[1:]:
      d = y[h] - y[neg]
      dsq = (d * d).sum(1)
      coeff = (2.0 * b) / ((0.001 + dsq) * (a * dsq ** b + 1.0))
      g = torch.where(dsq[:, None] > 0.0,
                      torch.clamp(coeff[:, None] * d, -4.0, 4.0),
                      torch.full_like(d, 4.0)) * alpha
      y.index_put_((h,), g, accumulate=True)
  return y.cpu().numpy().astype(np.float32)

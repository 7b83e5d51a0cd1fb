"""Kraskov kNN mutual information between every gene and every protein,
on the card (port of ``sisua_tpu/ops/knn_mi.py``).

In the JAX package this is XLA, not Pallas (``_build_kernel``), so here it
is torch operations on the device and no hand kernel. The estimator is
sklearn's ``_compute_mi_cc`` as the JAX function computes it: columns
scaled by their std, then a tie-breaking jitter from ONE numpy
``RandomState(random_state)`` stream (X before Y) added in float64 and cast
to float32, so both packages see the same float32 operands and count the
same neighbours; the radius is the k-th smallest non-self Chebyshev
distance in the joint (x, y) space (self excluded by +inf written at the
query's own cell, never a 0·inf product); the marginal counts are strict
``<`` counts minus one; ``ψ(N) + ψ(k) − Σψ(nx+1)/N − Σψ(ny+1)/N``,
clipped at 0.

Memory: one dispatch covers ``chunk`` genes × ``qblock`` query cells × all
proteins, and its (chunk, qblock, N) float32 tiles stay within
``mem_budget_bytes`` (the JAX defaults); the (N, N) matrix is never made.
The protein matrix goes to the device once, each gene chunk once. Each
tile's digamma sums are float32 on the device, accumulated in float64 on
the host, as in the JAX function.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["knn_mutual_information"]


def _host64(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    a = a.detach().cpu().numpy()
  elif hasattr(a, "toarray"):
    a = a.toarray()
  return np.asarray(a, np.float64)


def _prep(A: np.ndarray, rng: np.random.RandomState,
          noise: float) -> np.ndarray:
  """sklearn's ``scale(with_mean=False)`` then the tie-breaking jitter."""
  sd = A.std(axis=0)
  A = A / np.where(sd > 0, sd, 1.0)
  amp = noise * np.maximum(1.0, np.mean(np.abs(A), axis=0))
  return (A + amp * rng.standard_normal(A.shape)).astype(np.float32)


def _mi_block(xc: torch.Tensor, ys: torch.Tensor, qlo: int, k: int,
              qblock: int):
  """Digamma sums of one gene-chunk × query-block tile, for every protein.

  xc: (C, N) scaled gene columns; ys: (P, N) scaled protein columns.
  Returns (sx, sy), each (P, C): the sums over the block's valid query
  cells of ψ(nx+1) and ψ(ny+1)."""
  n = xc.shape[1]
  qidx = qlo + torch.arange(qblock, device=xc.device)
  valid = (qidx < n).to(xc.dtype)                              # (Q,)
  qc = torch.clamp_max(qidx, n - 1)                            # clamp pads
  dx = torch.abs(xc[:, qc, None] - xc[:, None, :])             # (C, Q, N)
  sx, sy = [], []
  for y in ys:
    dy = torch.abs(y[qc, None] - y[None, :])                   # (Q, N)
    d = torch.maximum(dx, dy)
    # self excluded: +inf written at (q, qlo + q), the valid queries' own
    # cells (never a 0·inf product)
    torch.diagonal(d, offset=qlo, dim1=1, dim2=2).fill_(math.inf)
    r = torch.topk(d, k, dim=-1, largest=False).values[..., -1:]  # (C, Q, 1)
    del d
    # strictly closer than the k-th neighbour, self included, minus one
    nx = torch.sum(dx < r, dim=-1, dtype=torch.int32).to(xc.dtype) - 1.0
    ny = torch.sum(dy < r, dim=-1, dtype=torch.int32).to(xc.dtype) - 1.0
    sx.append(torch.sum(torch.special.digamma(nx + 1.0) * valid, dim=-1))
    sy.append(torch.sum(torch.special.digamma(ny + 1.0) * valid, dim=-1))
  return torch.stack(sx), torch.stack(sy)


def _mi_prepared(Xs: np.ndarray, Ys: np.ndarray, n_neighbors: int,
                 chunk: int, qblock: int, dev: torch.device) -> np.ndarray:
  """The (G, P) estimate from the scaled, jittered float32 columns."""
  from scipy.special import digamma
  n, g = Xs.shape
  pad = (-g) % chunk
  if pad:
    # pad with the first column: every chunk has one shape; discarded
    Xs = np.concatenate([Xs, np.repeat(Xs[:, :1], pad, axis=1)], axis=1)
  ys = torch.as_tensor(np.ascontiguousarray(Ys.T), device=dev)  # (P, N)
  sx = np.zeros((g + pad, Ys.shape[1]))
  sy = np.zeros((g + pad, Ys.shape[1]))
  with torch.no_grad():
    for lo in range(0, g + pad, chunk):
      xc = torch.as_tensor(np.ascontiguousarray(Xs[:, lo:lo + chunk].T),
                           device=dev)
      for qlo in range(0, n, qblock):
        bx, by = _mi_block(xc, ys, qlo, int(n_neighbors), int(qblock))
        sx[lo:lo + chunk] += bx.cpu().numpy().T
        sy[lo:lo + chunk] += by.cpu().numpy().T
  base = float(digamma(float(n)) + digamma(float(n_neighbors)))
  return np.maximum(base - sx[:g] / n - sy[:g] / n, 0.0)


def knn_mutual_information(X, Y,
                           n_neighbors: int = 3,
                           random_state: int = 8,
                           noise: float = 1e-5,
                           chunk: Optional[int] = None,
                           qblock: Optional[int] = None,
                           max_cells: Optional[int] = None,
                           mem_budget_bytes: int = 2 << 30,
                           device="cuda") -> np.ndarray:
  """MI matrix between every column of ``X`` (N × G) and of ``Y`` (N × P):
  a (G, P) float64 array of Kraskov kNN estimates, in nats. ``X`` and
  ``Y`` are numpy arrays, scipy matrices or tensors. ``chunk`` genes ×
  ``qblock`` query cells go to the device per dispatch (defaults: qblock
  min(N, 2048), chunk sized so the (chunk, qblock, N) float32 working set
  fits ``mem_budget_bytes``). ``max_cells`` subsamples the cells with a
  seeded permutation first. ``device='cpu'`` runs the same operations on
  the CPU."""
  from ..models.base import resolve_device
  dev = resolve_device(device)
  X, Y = _host64(X), _host64(Y)
  if max_cells is not None and X.shape[0] > max_cells:
    sel = np.random.RandomState(random_state).permutation(
        X.shape[0])[:max_cells]
    X, Y = X[sel], Y[sel]
  n, g = X.shape
  if qblock is None:
    qblock = min(n, 2048)
  if chunk is None:
    # dx + d + comparisons live concurrently → ~4 tile-sized f32 buffers
    chunk = max(1, min(g, mem_budget_bytes // max(1, 4 * 4 * qblock * n)))
  rng = np.random.RandomState(random_state)
  Xs = _prep(X, rng, noise)
  Ys = _prep(Y, rng, noise)
  return _mi_prepared(Xs, Ys, n_neighbors, int(chunk), int(qblock), dev)

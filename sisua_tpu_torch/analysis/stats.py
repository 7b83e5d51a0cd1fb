"""The statistics of the JAX data analyzer on the card: the rank tests of
``rank_vars_groups``, the correlations of ``get_correlation`` and
``mutual_info_regression``'s Kraskov estimator, as scipy 1.17 and sklearn
1.9 compute them (``sisua_tpu/data/analysis.py:501-536,639-760``),
without sklearn.

  * ``welch_ttest``: scipy's ``ttest_ind(equal_var=False)`` of every
    column, group against the rest: the means and variances reduced on
    ``device`` in numpy's order and dtype (``column_sum``), the rest of
    scipy's arithmetic and ``scipy.special.stdtr`` on the host. scipy
    keeps a float32 input in float32, and so does this.
  * ``mannwhitneyu``: scipy's ``mannwhitneyu`` (two-sided, continuity
    correction, ``method='auto'``) of every column at once: the average
    ranks of each column by a sort on ``device``, the rank sum of the
    group, scipy's tie term Σ(t³ − t) over the column's ties. scipy keeps
    a float32 input in float32 for the normal approximation; so does
    this, on the host from the card's exact rank sums and tie counts. A
    column that scipy would test exactly (either group ≤ 8 with no tie)
    is handed to scipy.
  * ``average_ranks``: scipy's ``rankdata(method='average')`` of every
    column, and its tie counts, on ``device``.
  * ``mutual_info_regression``: sklearn's estimator step by step: each
    column scaled by its std (sklearn's ``scale(with_mean=False)``) and
    jittered by 1e-10·max(1, mean|x|)·N(0, 1) from one
    ``RandomState(random_state)`` (X's columns, then y) on the host, as
    sklearn does; then, on ``device`` in float64, the Chebyshev distance
    to the k-th neighbour in (x, y) (self excluded), the
    neighbours within it in x and in y counted exactly (binary searches
    of the sorted columns for ``|x_j − x_i| ≤ nextafter(r, 0)``), and
    ψ(N) + ψ(k) − ⟨ψ(nx + 1)⟩ −
    ⟨ψ(ny + 1)⟩ clipped at 0.

Every entry point takes ``device`` (default ``'cuda'``, which must
exist; ``'cpu'`` on request).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .estimators import _resolve

__all__ = ["column_sum", "divide", "average_ranks", "welch_ttest", "mannwhitneyu", "correlations",
           "mutual_info_regression"]

_MI_BUDGET = 1 << 30   # bytes of one block of float64 joint distances


def _as(X, dev, dtype=torch.float64) -> torch.Tensor:
  t = X.detach() if isinstance(X, torch.Tensor) else torch.as_tensor(
      np.asarray(X))
  return t.to(device=dev, dtype=dtype)


def average_ranks(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(ranks, ties) of each column of X (n, d): the average ranks
  (1-based, float64), and scipy ``_rankdata``'s tie counts: in sorted
  order, each tie group's size at its first position, 0 elsewhere."""
  n = X.shape[0]
  vals, order = torch.sort(X, dim=0, stable=True)
  first = torch.ones_like(vals, dtype=torch.bool)
  first[1:] = vals[1:] != vals[:-1]
  last = torch.ones_like(first)
  last[:-1] = first[1:]
  pos = torch.arange(n, device=X.device)[:, None].expand_as(vals)
  start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                       0).values
  end = torch.flip(torch.cummin(torch.flip(torch.where(
      last, pos, torch.full_like(pos, n - 1)), (0,)), 0).values, (0,))
  avg = (start + end).to(torch.float64) / 2.0 + 1.0
  ranks = torch.empty_like(avg)
  ranks.scatter_(0, order, avg)
  ties = torch.where(first, (end - start + 1).to(torch.float64),
                     torch.zeros_like(avg))
  return ranks, ties


def column_sum(X: torch.Tensor) -> torch.Tensor:
  """numpy's ``X.sum(0)`` of a C-ordered matrix, in X's dtype: numpy
  reduces a non-contiguous axis row by row, each column accumulated in
  row order; so does this, one row at a time (torch's cumulative sum
  accumulates a float32 column in float64 on the CPU, and its sums pair
  the terms)."""
  acc = X[0].clone()
  for i in range(1, X.shape[0]):
    acc += X[i]
  return acc


def divide(a: torch.Tensor, n) -> torch.Tensor:
  """a / n as numpy divides: on the card a division by a Python number
  multiplies by 1/n (an ulp off), a tensor divisor divides."""
  return a / torch.full_like(a, n)


def welch_ttest(X, in_group, device="cuda"
                ) -> Tuple[np.ndarray, np.ndarray]:
  """(t, p): Welch's t of every column, ``in_group`` rows against the
  others, and its two-sided p-value, in X's dtype as scipy computes them:
  the group means and ``ddof=1`` variances reduced on ``device`` in
  numpy's order, the rest of scipy's arithmetic on the host."""
  from scipy.special import stdtr
  dev = _resolve(device)
  Xt = X.detach() if isinstance(X, torch.Tensor) else torch.as_tensor(
      np.asarray(X))
  if not Xt.is_floating_point():
    Xt = Xt.to(torch.float64)
  Xt = Xt.to(dev)
  g = torch.as_tensor(np.asarray(in_group, bool), device=dev)
  dt = torch.empty((), dtype=Xt.dtype).numpy().dtype

  def moments(A):
    n = A.shape[0]
    m = divide(column_sum(A), n)
    d = A - m
    v = divide(column_sum(d * d), n).cpu().numpy()
    nn = dt.type(n)
    return m.cpu().numpy(), v * (nn / (nn - dt.type(1))), n

  m1, v1, n1 = moments(Xt[g])
  m2, v2, n2 = moments(Xt[~g])
  with np.errstate(divide="ignore", invalid="ignore"):
    vn1, vn2 = v1 / n1, v2 / n2
    df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (n1 - 1) + vn2 ** 2 / (n2 - 1))
    df = np.where(np.isnan(df), 1., df)
    t = np.divide(m1 - m2, np.sqrt(vn1 + vn2))
    p = 2 * stdtr(np.asarray(df, dtype=t.dtype), -np.abs(t))
  return t, p


def mannwhitneyu(X, in_group, device="cuda", ranks=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
  """(U, p): the Mann-Whitney U of the ``in_group`` rows of every column
  against the others, and its two-sided p-value (see the module
  docstring); ``ranks`` reuses ``average_ranks(X)`` across groups. U and
  p are float32 for a float32 X, as scipy gives them."""
  from scipy import special, stats
  dev = _resolve(device)
  Xt = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
  f32 = Xt.dtype == torch.float32
  rdt = np.float32 if f32 else np.float64
  if ranks is None:
    ranks = average_ranks(_as(Xt, dev))
  R, ties = ranks
  mask = np.asarray(in_group, bool)
  g = torch.as_tensor(mask, device=dev)
  n1, n2 = int(mask.sum()), int((~mask).sum())
  n = n1 + n2
  U1 = (R[g].sum(0) - n1 * (n1 + 1) / 2).cpu().numpy().astype(rdt)
  U2 = rdt(n1 * n2) - U1
  U = np.maximum(U1, U2)
  t = ties.T.cpu().numpy().astype(rdt)          # (columns, sorted rows)
  has_ties = (t > 1).any(1)
  tie_term = np.sum(t ** 3 - t, axis=-1)
  mu = n1 * n2 / 2
  s = np.sqrt(n1 * n2 / 12 * ((n + 1) - tie_term / (n * (n - 1))))
  with np.errstate(divide="ignore", invalid="ignore"):
    z = (U - mu - 0.5) / s
  p = special.ndtr(-z) * 2
  exact = ~has_ties & (min(n1, n2) <= 8)
  if exact.any():
    Xh = Xt.detach().cpu().numpy() if isinstance(Xt, torch.Tensor) else Xt
    for j in np.flatnonzero(exact):
      p[j] = stats.mannwhitneyu(Xh[mask, j], Xh[~mask, j],
                                method="exact").pvalue
  return U1, np.clip(p, 0.0, 1.0).astype(rdt)


def correlations(X, Y, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
  """(pearson, spearman), each (d1, d2): every column of X against every
  column of Y as the JAX analyzer forms them: z-scores (std + 1e-12) and
  their mean product; Spearman's from the average ranks."""
  dev = _resolve(device)
  X, Y = _as(X, dev), _as(Y, dev)

  def corr(A, B):
    A = (A - A.mean(0)) / (A.std(0, correction=0) + 1e-12)
    B = (B - B.mean(0)) / (B.std(0, correction=0) + 1e-12)
    return (A.T @ B) / A.shape[0]

  pear = corr(X, Y)
  spear = corr(average_ranks(X)[0], average_ranks(Y)[0])
  return pear.cpu().numpy(), spear.cpu().numpy()


# ------------------------------------------------------ mutual information
def _scale(A: np.ndarray) -> np.ndarray:
  """sklearn's ``scale(with_mean=False)`` of each column (of a vector)."""
  sd = np.nanstd(A, axis=0)
  sd = np.where(sd < 10 * np.finfo(sd.dtype).eps, 1.0, sd)
  return A / sd


def _count_within(xs: torch.Tensor, x: torch.Tensor, r: torch.Tensor
                  ) -> torch.Tensor:
  """#{j : |xs_j − x_i| ≤ r_i} for every i, per row of the sorted
  ``xs`` (B, n): two binary searches with the exact test. Floating
  subtraction is monotone, so ``xs_j − x > r`` holds from some j on and
  ``x − xs_j ≤ r`` from some j on; the count is the gap between the two
  first positions."""
  n = xs.shape[1]

  def first(pred):
    lo = torch.zeros_like(x, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    for _ in range(max(1, n.bit_length())):
      mid = (lo + hi) // 2
      v = xs.gather(1, torch.clamp(mid, max=n - 1))
      ok = pred(v) & (mid < hi)
      hi = torch.where(ok, mid, hi)
      lo = torch.where(ok | (mid >= hi), lo, mid + 1)
    return hi

  return first(lambda v: v - x > r) - first(lambda v: x - v <= r)


def _kraskov(xc: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
  """sklearn's ``_compute_mi_cc`` of each row of xc (C, n) against y (n):
  (C,) float64 nats."""
  C, n = xc.shape
  q = max(1, min(n, _MI_BUDGET // (8 * C * n)))
  radius = torch.empty((C, n), dtype=torch.float64, device=xc.device)
  for lo in range(0, n, q):
    # Chebyshev distances in (x, y), one (C, q, n) buffer
    d = (xc[:, lo:lo + q, None] - xc[:, None, :]).abs_()
    torch.maximum(d, (y[lo:lo + q, None] - y[None, :]).abs_(), out=d)
    # the k-th neighbour other than the point itself: the (k+1)-th value
    # of the row, which holds the point's own 0
    radius[:, lo:lo + q] = torch.topk(d, k + 1, dim=-1,
                                      largest=False).values[..., -1]
    del d
  radius = torch.nextafter(radius, torch.zeros_like(radius))
  xs = torch.sort(xc, dim=1).values
  ys = torch.sort(y).values.expand(C, n).contiguous()
  nx = _count_within(xs, xc, radius).to(torch.float64) - 1.0
  ny = _count_within(ys, y.expand_as(xc).contiguous(), radius).to(
      torch.float64) - 1.0
  psi = torch.special.digamma
  mi = (psi(torch.tensor(float(n), dtype=torch.float64))
        + psi(torch.tensor(float(k), dtype=torch.float64))).to(xc.device)
  mi = mi - psi(nx + 1.0).mean(1) - psi(ny + 1.0).mean(1)
  return torch.clamp_min(mi, 0.0)


def mutual_info_regression(X, y, n_neighbors: int = 3, random_state=None,
                           device="cuda") -> np.ndarray:
  """sklearn's ``mutual_info_regression(X, y, n_neighbors,
  random_state)`` (continuous features and target): (d,) float64."""
  from .estimators import check_random_state
  dev = _resolve(device)
  X = np.array(X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
               else X, dtype=np.float64)
  y = np.array(y.detach().cpu().numpy() if isinstance(y, torch.Tensor)
               else y, dtype=np.float64).ravel()
  n, d = X.shape
  rng = check_random_state(random_state)
  # sklearn scales and averages ``X[:, mask]``, a Fortran-ordered copy
  # (numpy then sums each column pairwise): the same copies here
  mask = np.ones(d, bool)
  X[:, mask] = _scale(X[:, mask])
  means = np.maximum(1, np.mean(np.abs(X[:, mask]), axis=0))
  X[:, mask] += 1e-10 * means * rng.standard_normal(size=(n, d))
  y = _scale(y)
  y += 1e-10 * np.maximum(1, np.mean(np.abs(y))) * rng.standard_normal(
      size=n)
  xt = torch.as_tensor(np.ascontiguousarray(X.T), device=dev)
  yt = torch.as_tensor(y, device=dev)
  step = max(1, min(d, 64))
  with torch.no_grad():
    out = [_kraskov(xt[lo:lo + step], yt, int(n_neighbors))
           for lo in range(0, d, step)]
  return torch.cat(out).cpu().numpy()

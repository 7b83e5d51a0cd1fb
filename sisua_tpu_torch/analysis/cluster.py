"""Nearest neighbours and the clusterings of the JAX data analyzer, as
sklearn 1.9 computes them (``sisua_tpu/data/analysis.py::neighbors`` and
``clustering``), without sklearn.

  * ``kneighbors``: the k nearest rows of every row by exact Euclidean
    distance in float64 on ``device`` (``cdist`` without the matmul
    shortcut, then ``topk``), ordered by (distance, index) as sklearn's
    brute search returns them, the row itself first at distance 0.
    sklearn's brute search ranks by ‖x‖² − 2x·y + ‖y‖², so its distances
    carry rounding of order 1e-7 of ‖x‖² (a row's distance to itself too);
    these are exact.
  * ``AgglomerativeClustering`` (Ward, no connectivity): the merge tree of
    scipy's ``hierarchy.ward`` on the host (as sklearn's ``ward_tree``
    builds it there) and sklearn's ``_hc_cut``.
  * ``SpectralClustering`` (rbf affinity, γ = 1, ``assign_labels=
    'discretize'``): X in float64 as sklearn takes it; the affinity and
    the normalized Laplacian on
    ``device``; the eigenvectors by ARPACK on the host (scipy's ``eigsh``,
    shift-invert at σ = −1e-5 with sklearn's ``v0``), each shift-invert
    solve against a float64 LU factorization made once on ``device``
    (scipy factors in float64 too); then
    sklearn's sign flip and ``discretize`` (its rotation search with the
    same ``randint`` draws) on ``device``.

Every entry point takes ``device`` (default ``'cuda'``, which must
exist; ``'cpu'`` on request).
"""

from __future__ import annotations

from heapq import heappush, heappushpop
from typing import Tuple

import numpy as np
import torch

from .estimators import _float_matrix, _resolve, check_random_state

__all__ = ["kneighbors", "AgglomerativeClustering", "SpectralClustering",
           "spectral_embedding", "discretize"]

_KNN_BUDGET = 256 << 20   # bytes of one block of float64 distances


def kneighbors(X, n_neighbors: int, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(distances float64, indices int64), each (n, k): every row's k
  nearest rows of X (itself included), nearest first, ties by index."""
  dev = _resolve(device)
  X = _float_matrix(X, dev).to(torch.float64)
  n = X.shape[0]
  k = int(n_neighbors)
  if not 1 <= k <= n:
    raise ValueError(f"n_neighbors={k} must be in [1, {n}]")
  step = max(1, _KNN_BUDGET // (8 * n))
  dists, idx = [], []
  for lo in range(0, n, step):
    d = torch.cdist(X[lo:lo + step], X,
                    compute_mode="donot_use_mm_for_euclid_dist")
    # topk's order among equal values is unspecified: take a margin of
    # the row's k-th value, then sort (index, then distance, stably)
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1:]
    cand = d <= kth
    m = int(cand.sum(1).max())
    vals, pos = torch.topk(torch.where(cand, d, torch.full_like(d, np.inf)),
                           m, dim=1, largest=False)
    pos, order = torch.sort(pos, dim=1)
    vals = vals.gather(1, order)
    vals, order = torch.sort(vals, dim=1, stable=True)
    dists.append(vals[:, :k])
    idx.append(pos.gather(1, order)[:, :k])
  return torch.cat(dists), torch.cat(idx)


# ------------------------------------------------------------ agglomerative
def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int
            ) -> np.ndarray:
  """sklearn's ``_hc_cut``: the labels of the top ``n_clusters`` subtrees
  of the merge tree."""
  if n_clusters > n_leaves:
    raise ValueError(f"Cannot extract more clusters than samples: "
                     f"{n_clusters} clusters were given for a tree with "
                     f"{n_leaves} leaves.")
  nodes = [-(max(children[-1]) + 1)]
  for _ in range(n_clusters - 1):
    these = children[-nodes[0] - n_leaves]
    heappush(nodes, -these[0])
    heappushpop(nodes, -these[1])
  label = np.zeros(n_leaves, dtype=np.intp)
  for i, node in enumerate(nodes):
    stack, leaves = [-node], []
    while stack:
      j = stack.pop()
      if j < n_leaves:
        leaves.append(j)
      else:
        stack.extend(children[j - n_leaves])
    label[leaves] = i
  return label


class AgglomerativeClustering:
  """sklearn's ``AgglomerativeClustering(n_clusters)``: Ward linkage on
  Euclidean distances, the full tree, cut at ``n_clusters``."""

  def __init__(self, n_clusters: int = 2):
    self.n_clusters = int(n_clusters)

  def fit(self, X, y=None) -> "AgglomerativeClustering":
    from scipy.cluster import hierarchy
    if isinstance(X, torch.Tensor):
      X = X.detach().cpu().numpy()
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
      X = X.astype(np.float64)
    out = hierarchy.ward(np.require(X, requirements="W"))
    self.children_ = out[:, :2].astype(np.intp)
    self.n_leaves_ = X.shape[0]
    self.labels_ = _hc_cut(self.n_clusters, self.children_, self.n_leaves_)
    return self

  def fit_predict(self, X, y=None) -> np.ndarray:
    return self.fit(X).labels_


# ----------------------------------------------------------------- spectral
def _rbf_affinity(X: torch.Tensor, gamma: float) -> torch.Tensor:
  """sklearn's ``rbf_kernel``: exp(−γ·d²) with sklearn's squared
  distances −2x·y + ‖x‖² + ‖y‖² (in that order, clipped at 0, the
  diagonal 0)."""
  sq = torch.sum(X * X, 1)
  d = -2.0 * (X @ X.T)
  d += sq[:, None]
  d += sq[None, :]
  d = torch.clamp_min(d, 0.0)
  d.fill_diagonal_(0.0)
  return torch.exp(d * -gamma)


def spectral_embedding(adjacency: torch.Tensor, n_components: int,
                       random_state=None) -> torch.Tensor:
  """sklearn's ``_spectral_embedding(drop_first=False)`` of a dense
  affinity with ARPACK: (n, n_components) in the affinity's dtype."""
  from scipy.sparse.linalg import LinearOperator, eigsh
  rs = check_random_state(random_state)
  A = adjacency
  n = A.shape[0]
  # scipy's dense normalized laplacian, then sklearn's unit diagonal
  m = A.clone()
  m.fill_diagonal_(0.0)
  w = m.sum(0)
  isolated = w == 0
  w = torch.where(isolated, torch.ones_like(w), torch.sqrt(w))
  m /= w
  m /= w[:, None]
  m *= -1
  m.fill_diagonal_(1.0)
  dt = torch.empty((), dtype=A.dtype).numpy().dtype
  # scipy factors A − σI in float64 (np.eye promotes a float32 A)
  lu, piv = torch.linalg.lu_factor(
      m.to(torch.float64)
      - (-1e-5) * torch.eye(n, dtype=torch.float64, device=m.device))

  def solve(v):
    b = torch.as_tensor(np.asarray(v, np.float64).reshape(n, -1),
                        device=m.device)
    return torch.linalg.lu_solve(lu, piv, b).cpu().numpy().reshape(v.shape)

  op = LinearOperator((n, n), matvec=lambda v: (m @ torch.as_tensor(
      np.asarray(v, dt), device=m.device)).cpu().numpy(), dtype=dt)
  opinv = LinearOperator((n, n), matvec=solve, dtype=dt)
  v0 = rs.uniform(-1, 1, n)
  _, vecs = eigsh(op, k=n_components, sigma=-1e-5, which="LM", tol=0,
                  v0=v0, OPinv=opinv)
  emb = torch.as_tensor(vecs.T[:n_components], device=m.device) / w
  # sklearn's _deterministic_vector_sign_flip
  top = torch.argmax(torch.abs(emb), dim=1)
  emb = emb * torch.sign(emb.gather(1, top[:, None]))
  return emb[:n_components].T


_SVD_RESTARTS = 30   # sklearn's discretize defaults
_ROTATION_STEPS = 20


def discretize(vectors: torch.Tensor, random_state=None) -> torch.Tensor:
  """sklearn's ``discretize``: the labels of a spectral embedding by the
  rotation search of Yu & Shi, with sklearn's draws."""
  rs = check_random_state(random_state)
  v = vectors.clone()
  eps = float(np.finfo(float).eps)
  n, k = v.shape
  norm_ones = float(np.sqrt(n))
  for i in range(k):
    v[:, i] = v[:, i] / torch.linalg.norm(v[:, i]) * norm_ones
    if v[0, i] != 0:
      v[:, i] = -1 * v[:, i] * torch.sign(v[0, i])
  v = v / torch.sqrt((v ** 2).sum(1))[:, None]
  rows = torch.arange(n, device=v.device)
  for _ in range(_SVD_RESTARTS):
    rotation = torch.zeros((k, k), dtype=torch.float64, device=v.device)
    rotation[:, 0] = v[rs.randint(n), :]
    c = torch.zeros(n, dtype=torch.float64, device=v.device)
    for j in range(1, k):
      c += torch.abs(v.to(torch.float64) @ rotation[:, j - 1])
      rotation[:, j] = v[int(torch.argmin(c)), :]
    last = 0.0
    n_iter = 0
    while True:
      n_iter += 1
      labels = torch.argmax(v.to(torch.float64) @ rotation, dim=1)
      onehot = torch.zeros((n, k), dtype=torch.float64, device=v.device)
      onehot[rows, labels] = 1.0
      t_svd = onehot.T @ v.to(torch.float64)
      try:
        U, S, Vh = torch.linalg.svd(t_svd)
      except RuntimeError:
        break
      ncut = 2.0 * (n - float(S.sum()))
      if abs(ncut - last) < eps or n_iter > _ROTATION_STEPS:
        return labels
      last = ncut
      rotation = Vh.T @ U.T
  raise np.linalg.LinAlgError("SVD did not converge")


class SpectralClustering:
  """sklearn's ``SpectralClustering(n_clusters, random_state,
  assign_labels='discretize')`` with the rbf affinity (γ = 1) of the
  rows of X (see the module docstring)."""

  def __init__(self, n_clusters: int = 8, random_state=None,
               device="cuda"):
    self.n_clusters = int(n_clusters)
    self.random_state = random_state
    self.device = device

  def fit(self, X, y=None) -> "SpectralClustering":
    # sklearn validates X as float64
    X = _float_matrix(X, _resolve(self.device)).to(torch.float64)
    rs = check_random_state(self.random_state)
    self.affinity_matrix_ = _rbf_affinity(X, 1.0)
    maps = spectral_embedding(self.affinity_matrix_, self.n_clusters, rs)
    self.labels_ = discretize(maps, rs)
    return self

  def fit_predict(self, X, y=None) -> torch.Tensor:
    return self.fit(X).labels_

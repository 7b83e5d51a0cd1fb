"""The port's t-SNE (``sisua_tpu_torch/analysis/manifold.py`` with the
tree and forces of ``native/tsne.cpp``) against sklearn 1.9's Barnes-Hut
``TSNE``, on the CPU (``device='cpu'``), at ≤ 300 points.

  * neighbours: sklearn's ``NearestNeighbors`` on both of its paths
    (brute force above 15 features, a kd-tree at ≤ 15): indices equal,
    distances within 1e-12 relative (measured equal: the brute force's
    ‖x‖² + (−2x·y) + ‖y‖² and its float32 square root are kept);
  * P: ``_joint_probabilities_nn`` from sklearn's own kNN graph and from
    the port's, within 1e-7 of the largest probability (measured 6e-16);
  * the forces: sklearn's ``_barnes_hut_tsne.gradient`` at
    ``num_threads=1`` in 2-D (quadtree) and 3-D (octree, Student-t with
    2 degrees of freedom), within 1e-6 of the largest |force|, and
    measured bitwise equal, the error too;
  * 250 iterations (the early-exaggeration phase) from one float32
    ``init`` array under ``threadpool_limits(1, 'openmp')`` on both
    sides, within 1e-3 of the embedding's range: measured bitwise equal
    in 2-D and 3-D;
  * a default run (PCA start, 1,000 iterations) on float64 input: KL
    within 2% and trustworthiness within 0.02 of sklearn's; measured
    bitwise equal embeddings, since the float64 PCA starts (the 'full'
    solver at 200 × 30) round to the same float32 values. On float32
    input the PCA starts differ in the last
    bits (sklearn's LAPACK against torch's), and t-SNE's descent
    amplifies that: in 3-D sklearn's own KL moves by up to 27% when its
    start moves by 1e-6 (see ``test_torch_port_analyzer`` for a float32
    run against the JAX analyzer);
  * ``trustworthiness`` equal to sklearn's.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from sklearn.manifold import TSNE as SKTSNE
from sklearn.manifold import _barnes_hut_tsne
from sklearn.manifold import trustworthiness as sk_trustworthiness
from sklearn.manifold._t_sne import _joint_probabilities_nn as sk_joint
from sklearn.neighbors import NearestNeighbors
from threadpoolctl import threadpool_limits

from sisua_tpu_torch import native
from sisua_tpu_torch.analysis import manifold as M

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(n)


def _blobs(n, f, sep, dtype=np.float32, seed=0):
  rng = np.random.RandomState(seed)
  centers = rng.normal(size=(5, f)) * sep
  return (centers[rng.randint(0, 5, n)]
          + rng.normal(size=(n, f))).astype(dtype)


@pytest.mark.parametrize("n,f,method", [(300, 50, "brute"),
                                        (300, 10, "kd_tree"),
                                        (150, 8, "brute")])
def test_kneighbors_and_P_as_sklearn(n, f, method):
  X = _blobs(n, f, 4)
  k = min(n - 1, int(3.0 * 30 + 1))
  knn = NearestNeighbors(n_neighbors=k).fit(X)
  assert knn._fit_method == method
  dist, ind = knn.kneighbors()
  idx, d = M._kneighbors(torch.as_tensor(X), k)
  np.testing.assert_array_equal(idx.numpy(), ind)
  np.testing.assert_allclose(d.numpy(), dist, rtol=1e-12, atol=0)
  graph = knn.kneighbors_graph(mode="distance")
  graph.data **= 2
  want = csr_matrix(sk_joint(graph, 30.0, 0))
  for source in ((torch.as_tensor(ind), torch.as_tensor(dist)), (idx, d)):
    indptr, indices, data = M._joint_probabilities_nn(*source, 30.0)
    got = csr_matrix((data.numpy(), indices.numpy(), indptr.numpy()),
                     shape=(n, n))
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0,
                               atol=1e-7 * want.data.max())


@pytest.mark.parametrize("nc", [2, 3])
def test_native_gradient_as_sklearn(nc):
  rng = np.random.RandomState(nc)
  n = 300
  pos = (rng.normal(size=(n, nc)) * 3).astype(np.float32)
  P = rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.1)
  np.fill_diagonal(P, 0)
  P = csr_matrix((P + P.T) / (P + P.T).sum())
  vals = P.data.astype(np.float32)
  nbrs = P.indices.astype(np.int64)
  indptr = P.indptr.astype(np.int64)
  dof = max(nc - 1, 1)
  want = np.zeros((n, nc), np.float32)
  err = _barnes_hut_tsne.gradient(vals, pos, nbrs, indptr, want, 0.5, nc,
                                  0, dof=dof, compute_error=True,
                                  num_threads=1)
  err2, got = native.tsne_gradient(vals, pos, nbrs, indptr, 0.5, dof, True,
                                   num_threads=1)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-6 * np.abs(want).max())
  np.testing.assert_array_equal(got, want)   # measured bitwise
  assert err2 == err
  _, no_err = native.tsne_gradient(vals, pos, nbrs, indptr, 0.5, dof,
                                   False, num_threads=1)
  np.testing.assert_array_equal(no_err, want)
  with pytest.raises(ValueError, match="2 or 3"):
    native.tsne_gradient(vals, np.zeros((n, 4), np.float32), nbrs, indptr)


@pytest.mark.parametrize("nc", [2, 3])
def test_exaggeration_phase_as_sklearn(nc):
  X = _blobs(300, 10, 4)
  init = (np.random.RandomState(nc).normal(size=(300, nc)) * 1e-4).astype(
      np.float32)
  with threadpool_limits(1, "openmp"):
    sk = SKTSNE(nc, init=init, max_iter=250, random_state=0).fit(X)
  port = M.TSNE(nc, init=init, max_iter=250, random_state=0, device=CPU,
                num_threads=1)
  got = port.fit_transform(X).numpy()
  span = np.ptp(sk.embedding_, 0).max()
  np.testing.assert_allclose(got, sk.embedding_, rtol=0, atol=1e-3 * span)
  np.testing.assert_array_equal(got, sk.embedding_)   # measured bitwise
  assert port.n_iter_ == sk.n_iter_
  assert port.learning_rate_ == sk.learning_rate_


@pytest.mark.parametrize("nc", [2, 3])
def test_default_run_as_sklearn(nc):
  X = _blobs(200, 30, 6, np.float64)
  with threadpool_limits(1, "openmp"):
    sk = SKTSNE(nc, random_state=0).fit(X)
  port = M.TSNE(nc, random_state=0, device=CPU, num_threads=1)
  got = port.fit_transform(X).numpy()
  assert got.dtype == np.float32 and got.shape == (200, nc)
  assert abs(port.kl_divergence_ - sk.kl_divergence_) <= 0.02 * \
      sk.kl_divergence_
  t_sk = sk_trustworthiness(X, sk.embedding_, n_neighbors=12)
  t_port = M.trustworthiness(X, got, n_neighbors=12, device=CPU)
  assert abs(t_port - t_sk) <= 0.02
  np.testing.assert_array_equal(got, sk.embedding_)   # measured bitwise
  assert port.n_iter_ == sk.n_iter_


def test_trustworthiness_as_sklearn():
  X = _blobs(200, 30, 3)
  E = np.random.RandomState(1).normal(size=(200, 2))
  for k in (5, 12):
    assert M.trustworthiness(X, E, n_neighbors=k, device=CPU) == \
        pytest.approx(sk_trustworthiness(X, E, n_neighbors=k), abs=1e-12)


def test_tsne_refuses_as_sklearn():
  with pytest.raises(ValueError, match="2 or 3"):
    M.TSNE(4)
  with pytest.raises(ValueError, match="perplexity"):
    M.TSNE(2, device=CPU).fit_transform(np.zeros((20, 3), np.float32))
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cuda'"):
      M.TSNE(2).fit_transform(_blobs(50, 3, 4))

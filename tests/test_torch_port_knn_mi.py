"""The port's kNN mutual information (``sisua_tpu_torch.ops.knn_mi``,
``device='cpu'``) against the JAX package's
``sisua_tpu.ops.knn_mi.knn_mutual_information`` on the same numpy inputs.

Both jitter in float64 from one ``RandomState`` and cast to float32, so
they count the same neighbours; what is left is float32 digamma sums in
another order. Tolerance: atol 1e-5 nats.
"""

import numpy as np
import pytest
import torch

from sisua_tpu.ops.knn_mi import knn_mutual_information as jax_mi
from sisua_tpu_torch.ops import knn_mi as port
from sisua_tpu_torch.ops.knn_mi import knn_mutual_information as port_mi
from torch_port_threads import _one_thread  # noqa: F401


ATOL = 1e-5


def _continuous(seed, n=160, g=10, p=3):
  rng = np.random.RandomState(seed)
  z = rng.randn(n, 4)
  X = z @ rng.randn(4, g) + 0.5 * rng.randn(n, g)
  Y = z @ rng.randn(4, p) + 0.5 * rng.randn(n, p)
  return X, Y


def _counts(seed, n=160, g=10, p=3):
  """Poisson counts: most distances tie before the jitter."""
  rng = np.random.RandomState(seed)
  z = rng.gamma(2.0, 1.0, size=(n, 2))
  X = rng.poisson(z @ rng.uniform(0.3, 2.0, (2, g))).astype(np.float32)
  Y = rng.poisson(z @ rng.uniform(0.3, 2.0, (2, p))).astype(np.float32)
  return X, Y


DATA = {"continuous": _continuous, "counts": _counts}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", list(DATA))
def test_matches_jax(kind, k):
  X, Y = DATA[kind](k)
  want = jax_mi(X, Y, n_neighbors=k)
  got = port_mi(X, Y, n_neighbors=k, device="cpu")
  assert got.shape == want.shape == (10, 3) and got.dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  assert (got >= 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("chunk,qblock", [(3, 64), (4, 160), (10, 77)],
                         ids=["padded_chunk_and_block", "padded_chunk",
                              "padded_block"])
def test_chunk_and_qblock_invariance(chunk, qblock):
  """10 genes in chunks of 3 or 4 pad the last chunk with the first
  column; 160 cells in blocks of 64 or 77 pad the last block."""
  X, Y = _counts(7)
  want = jax_mi(X, Y, chunk=chunk, qblock=qblock)
  got = port_mi(X, Y, chunk=chunk, qblock=qblock, device="cpu")
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  np.testing.assert_allclose(got, port_mi(X, Y, device="cpu"), rtol=0,
                             atol=ATOL)


def test_max_cells_subsamples_as_jax():
  X, Y = _continuous(3, n=200)
  want = jax_mi(X, Y, max_cells=120)
  got = port_mi(X, Y, max_cells=120, device="cpu")
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  assert np.abs(got - port_mi(X, Y, device="cpu")).max() > ATOL


def test_tensor_and_sparse_inputs():
  from scipy import sparse
  X, Y = _counts(11)
  want = port_mi(X, Y, device="cpu")
  np.testing.assert_array_equal(
      port_mi(torch.tensor(X), torch.tensor(Y), device="cpu"), want)
  np.testing.assert_array_equal(
      port_mi(sparse.csr_matrix(X), Y, device="cpu"), want)


@pytest.mark.parametrize("qlo", [0, 32])
def test_tile_matches_jax_on_exact_ties(qlo):
  """One (genes × query block) tile of unjittered counts, where distances
  tie exactly: the radius, the strict counts and the self exclusion (+inf
  on the diagonal, never 0·inf) give JAX's digamma sums; the second block
  runs past the last cell (padded queries count nothing)."""
  from sisua_tpu.ops.knn_mi import _build_kernel
  X, Y = _counts(5, n=48, g=4, p=2)
  xc, ys = X.T.copy(), Y.T.copy()
  jx, jy = _build_kernel(48, 3, 32)(xc, ys, np.int32(qlo))
  sx, sy = port._mi_block(torch.tensor(xc), torch.tensor(ys), qlo, 3, 32)
  np.testing.assert_allclose(sx.numpy(), np.asarray(jx), rtol=1e-6,
                             atol=1e-5)
  np.testing.assert_allclose(sy.numpy(), np.asarray(jy), rtol=1e-6,
                             atol=1e-5)
  assert torch.isfinite(sx).all() and torch.isfinite(sy).all()


def test_cuda_device_refused_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  X, Y = _continuous(0, n=20)
  with pytest.raises(RuntimeError, match="cuda"):
    port_mi(X, Y)

"""The port's UMAP (``sisua_tpu_torch/data/umap_impl.py``) against the JAX
package's (``sisua_tpu/data/umap_impl.py``), step by step on the same
inputs, then end to end. The port runs with ``device='cpu'``.

  * the kNN: indices equal to sklearn's; the non-self distances within
    1e-9 relative (sklearn's rounding of ‖x‖² − 2x·y + ‖y‖² in float64);
  * ρ and σ of the smooth-kNN calibration on the same distances: 1e-9
    relative; the fuzzy graph from the same kNN: the same edges, weights
    within 1e-9; the spectral initialization of the same graph within
    1e-6;
  * the SGD from the same graph: one epoch within 1e-4. Not five: numpy's
    float32 power (SIMD, not correctly rounded) and torch's differ in the
    last bit for a fifth to a half of the elements, and the layout's early
    epochs (learning rate 1, clipped at ±4) amplify such differences about
    25-fold an epoch: measured 1.5e-5 after one epoch, 3.6e-4 after two,
    3.1e-2 after five on a ±39 layout. Looser than a coordinate match for
    that reason, the default-epoch layouts are held by their quality:
    trustworthiness within 0.02 of the JAX layout's and the blobs apart as
    ``tests/test_umap.py`` holds them;
  * end to end on the analyzer's container: the port's kNN is exact, so
    a row's own distance is 0 where sklearn's is its rounding (which the
    JAX ρ then takes), and the graphs differ in those rows; held by
    trustworthiness within 0.02 of the JAX embedding's.
"""

import numpy as np
import pytest
import torch
from sklearn.manifold import trustworthiness
from sklearn.metrics import silhouette_score
from sklearn.neighbors import NearestNeighbors

import sisua_tpu.data.umap_impl as JU
import sisua_tpu_torch.data.umap_impl as TU
from sisua_tpu_torch.analysis import cluster as C
from torch_port_threads import _one_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture(scope="module")
def blobs():
  rng = np.random.default_rng(0)
  centers = rng.normal(0, 8, (3, 20))
  X = np.concatenate([c + rng.normal(0, 1, (120, 20)) for c in centers])
  return X, np.repeat(np.arange(3), 120)


@pytest.fixture(scope="module")
def knn(blobs):
  X, _ = blobs
  return NearestNeighbors(n_neighbors=16).fit(X).kneighbors(X)


def test_kneighbors_as_sklearn(blobs, knn):
  X, _ = blobs
  d, i = knn
  dt, it = C.kneighbors(X, 16, device=CPU)
  np.testing.assert_array_equal(it.numpy(), i)
  np.testing.assert_allclose(dt.numpy()[:, 1:], d[:, 1:], rtol=1e-9)
  assert (dt.numpy()[:, 0] == 0).all()


def test_smooth_knn_and_fuzzy_set_as_jax(blobs, knn, monkeypatch):
  X, _ = blobs
  d, i = knn
  rho, sigma = JU._smooth_knn_dist(d, k=16.0)
  rt, st = TU._smooth_knn_dist(torch.tensor(d), k=16.0)
  np.testing.assert_allclose(rt.numpy(), rho, rtol=1e-9)
  np.testing.assert_allclose(st.numpy(), sigma, rtol=1e-9)
  W = JU.fuzzy_simplicial_set(X, n_neighbors=15)
  monkeypatch.setattr(C, "kneighbors", lambda *a, **k: (torch.tensor(d),
                                                         torch.tensor(i)))
  Wt = TU.fuzzy_simplicial_set(X, n_neighbors=15, device=CPU)
  np.testing.assert_array_equal(Wt.row, W.row)
  np.testing.assert_array_equal(Wt.col, W.col)
  np.testing.assert_allclose(Wt.data, W.data, rtol=1e-9)
  np.testing.assert_allclose(TU._spectral_init(W.tocsr(), 2, 8),
                             JU._spectral_init(W.tocsr(), 2, 8), atol=1e-6)
  assert TU.find_ab_params(1.0, 0.1) == JU.find_ab_params(1.0, 0.1)


def test_sgd_epoch_as_jax(blobs, monkeypatch):
  X, _ = blobs
  W = JU.fuzzy_simplicial_set(X, n_neighbors=15)
  monkeypatch.setattr(TU, "fuzzy_simplicial_set", lambda *a, **k: W)
  for epochs, seed in ((1, 8), (1, 3)):
    want = JU.fit_umap(X, n_epochs=epochs, random_state=seed)
    got = TU.fit_umap(X, n_epochs=epochs, random_state=seed, device=CPU)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_default_epochs_layout_quality_as_jax(blobs):
  X, labels = blobs
  want = JU.fit_umap(X, random_state=8)
  got = TU.fit_umap(X, random_state=8, device=CPU)
  assert got.shape == (360, 2) and np.isfinite(got).all()
  tw, tg = (trustworthiness(X, e, n_neighbors=10) for e in (want, got))
  assert abs(tg - tw) <= 0.02
  assert silhouette_score(got, labels) > 0.5
  np.testing.assert_array_equal(TU.fit_umap(X, n_epochs=30, random_state=3,
                                            device=CPU),
                                TU.fit_umap(X, n_epochs=30, random_state=3,
                                            device=CPU))
  assert TU.fit_umap(X[:2], device=CPU).shape == (2, 2)


def test_dimension_reduce_umap_as_jax():
  from sisua_tpu.data import generate_synthetic as jgen
  from sisua_tpu_torch.data import generate_synthetic as tgen
  kw = dict(n_cells=600, n_genes=80, n_proteins=8, n_celltypes=4,
            seed=5218)
  j, t = jgen(**kw), tgen(**kw)
  a = j.dimension_reduce(n_components=2, algo="umap")
  b = t.dimension_reduce(n_components=2, algo="umap", device=CPU)
  assert b.shape == a.shape == (600, 2) and "transcriptomic_umap" in t.obsm
  assert t.obsm["transcriptomic_pca"].shape == (600, 50)   # 50 PCs first
  X = t.numpy()
  tw, tg = (trustworthiness(X, e, n_neighbors=10) for e in (a, b))
  assert abs(tg - tw) <= 0.02
  labels = np.argmax(t.numpy("celltype"), 1)
  assert silhouette_score(b, labels) > 0.0
  np.testing.assert_array_equal(
      t.dimension_reduce(n_components=2, algo="umap", device=CPU), b)

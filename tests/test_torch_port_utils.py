"""The port's ``utils`` (``sisua_tpu_torch/utils``) against the JAX
package's on the same inputs: equal results, except
``dimension_reduction('pca')``, held to 5e-5 of each column's range as
the analyzer's PCA is (``test_torch_port_analyzer``), and
``dimension_reduction('umap')``, where the JAX function falls back to
t-SNE without umap-learn and the port runs its UMAP (shape and
trustworthiness checked). CSV and feather files written by either
package read back equal in the other.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest
import torch

import sisua_tpu.utils as JU
import sisua_tpu_torch.utils as TU
from torch_port_threads import _one_thread_tsne  # noqa: F401

CPU = "cpu"


@pytest.mark.parametrize("ncpu", [1, 3])
def test_mpi_map_as_jax(ncpu):
  """In order, inline and in spawned workers (the port spawns: a fork
  under torch's and JAX's threads can deadlock); the JAX map runs inline
  here for the same reason."""
  jobs = [-3, 1, -4, 1, -5, 9, -2]
  assert TU.mpi_map(abs, jobs, ncpu=ncpu) == JU.mpi_map(
      abs, jobs, ncpu=1) == [abs(j) for j in jobs]


def test_filtering_experiment_path_as_jax(tmp_path):
  for d in ("sisua_pbmc_1", "vae_pbmc_2", "sisua_cbmc_3", "scvi_x_4"):
    os.makedirs(tmp_path / d)
  (tmp_path / "notadir_sisua").write_text("x")
  for incl, excl, ds in (("sisua", "", False), ("pbmc", "vae", True),
                         (["x"], [], True), ("", "cbmc,vae", False)):
    assert TU.filtering_experiment_path(
        str(tmp_path), incl, excl, return_dataset=ds) == \
        JU.filtering_experiment_path(str(tmp_path), incl, excl,
                                     return_dataset=ds)


def test_thresholds_images_and_rates_as_jax():
  rng = np.random.default_rng(3)
  T = rng.poisson(0.5, (20, 12)).astype(np.float32)
  W = rng.uniform(0, 1.5, (20, 12)).astype(np.float32)
  np.testing.assert_array_equal(TU.apply_threshold(W, 0.4),
                                JU.apply_threshold(W, 0.4))
  np.testing.assert_array_equal(TU.thresholding_by_sparsity(W, T),
                                JU.thresholding_by_sparsity(W, T))
  jt, jd = JU.thresholding_by_sparsity_matching(T, W, W, (W.copy(),), None)
  tt, td = TU.thresholding_by_sparsity_matching(T, W, W, (W.copy(),), None)
  assert tt == jt and td[2] is None
  np.testing.assert_array_equal(td[0], jd[0])
  np.testing.assert_array_equal(td[1][0], jd[1][0])
  for x in (np.arange(10.0), np.ones((3, 4)), np.ones((2, 3, 4))):
    np.testing.assert_array_equal(TU.anything2image(x),
                                  JU.anything2image(x))
  with pytest.raises(ValueError):
    TU.anything2image(np.ones((1, 1, 1, 1)))
  rates = [5.0, 9.0, 9.5, 10.0, 10.2, 9.9, 10.1]
  for epochs, interval in ((7, 1), (7, 3), (9, 3), (4, 8), (6, 2)):
    assert TU.steady_window_rates(rates, epochs, interval) == \
        JU.steady_window_rates(rates, epochs, interval)
  with TU.UnitTimer("t", print_log=False) as t:
    sum(range(1000))
  assert t.duration > 0.0


def test_dimension_reduction_as_jax():
  from sklearn.manifold import trustworthiness
  rng = np.random.default_rng(5)
  x = (rng.gamma(0.6, 2.0, (200, 30)) @ rng.normal(size=(30, 30))
       ).astype(np.float32)
  want = JU.dimension_reduction(x, "pca", 5, random_state=1)
  got = TU.dimension_reduction(x, "pca", 5, random_state=1, device=CPU)
  for c in range(5):
    np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                               atol=5e-5 * np.abs(want[:, c]).max())
  emb = TU.dimension_reduction(x, "umap", 2, device=CPU)
  assert emb.shape == (200, 2) and trustworthiness(x, emb) > 0.8
  # t-SNE (refused until the port had sklearn's Barnes-Hut t-SNE): on
  # 5 blobs in 30 columns (2-D) and in 60 columns, which go through PCA
  # to 50 first (3-D); the embeddings' trustworthiness within 0.02 of the
  # JAX function's (measured 1.7e-4 and 5.5e-3: the float32 PCA starts
  # differ in the last bits, which the descent amplifies; t-SNE itself is
  # held to sklearn in test_torch_port_tsne)
  def blobs(n, f, seed):
    r = np.random.RandomState(seed)
    centers = r.normal(size=(5, f)) * 3
    return (centers[r.randint(0, 5, n)] + r.normal(size=(n, f))
            ).astype(np.float32)
  for data, nc in ((blobs(200, 30, 1), 2), (blobs(150, 60, 2), 3)):
    want = JU.dimension_reduction(data, "tsne", nc)
    got = TU.dimension_reduction(data, "tsne", nc, device=CPU)
    assert got.shape == want.shape == (len(data), nc)
    assert got.dtype == np.float32
    assert abs(trustworthiness(data, got, n_neighbors=12)
               - trustworthiness(data, want, n_neighbors=12)) <= 0.02
  with pytest.raises(ValueError):
    TU.dimension_reduction(x, "lda", device=CPU)


def test_io_round_trips_with_jax(tmp_path):
  from sisua_tpu.data import SingleCellOMIC as JS
  from sisua_tpu_torch.data import SingleCellOMIC as TS
  rng = np.random.default_rng(9)
  x = (rng.poisson(2.0, (15, 6)) * rng.uniform(0.1, 3, (15, 6))
       ).astype(np.float32)
  names = [f"g{i}" for i in range(6)]
  j, t = JS(x, gene_id=names), TS(x, gene_id=names)
  # a port CSV, read by the JAX reader, and the other way round
  path = TU.save_data_to_csv(t, str(tmp_path / "t" / "x.csv.gz"))
  df = JU.load_data_from_csv(path)
  np.testing.assert_array_equal(df.values.astype(np.float32), x)
  assert list(df.columns) == names and list(df.index) == list(t.obs_names)
  jpath = JU.save_data_to_csv(j, str(tmp_path / "j" / "x.csv.gz"))
  got = TU.load_data_from_csv(jpath)
  assert list(got) == ["index"] + names
  np.testing.assert_array_equal(got["index"], df.index.values)
  for i, n in enumerate(names):
    np.testing.assert_array_equal(got[n], df[n].values)
    assert got[n].dtype == df[n].values.dtype
  with gzip.open(path, "rt") as f:
    assert f.readline().strip() == ",".join(["cell_id"] + names)
  plain = TU.save_data_to_csv(t, str(tmp_path / "x.csv"), compression=None)
  pd.testing.assert_frame_equal(pd.read_csv(plain, index_col=0),
                                pd.read_csv(jpath, index_col=0))
  # feather (pyarrow is in this environment)
  fj = JU.save_data_to_R(j, str(tmp_path / "j.feather"))
  ft = TU.save_data_to_R(t, str(tmp_path / "t.feather"))
  pd.testing.assert_frame_equal(pd.read_feather(ft), pd.read_feather(fj))
  assert TU.save_data(t, str(tmp_path / "s")) == str(tmp_path / "s")

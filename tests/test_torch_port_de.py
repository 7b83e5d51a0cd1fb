"""The port's ``differential_expression`` and count corruption against the
JAX package's.

* ``data.utils.apply_artificial_corruption``: bitwise equal (dense and
  CSR), the same numpy draws in the same order.
* DE at the same scale draws: both models' normalized-expression draws
  are replaced by one deterministic function of the rows each group
  subsample selects, so the same subsample, the same pairs and the same
  statistics must come out. rtol 1e-12 (the port runs the JAX package's
  numpy statements on the CPU); ``proba_*`` exact. The card's float64
  statistics (``_de_stats_torch``) run here on CPU tensors against the
  numpy version: rtol 1e-10, ``proba_*`` exact, an even ``n_pairs`` so
  the median averages two middle values.
* One end-to-end fit from the JAX model's converted initial weights: the
  posterior lfc tracks the empirical fold change (Spearman > 0.5, as
  tests/test_de.py requires of the JAX model).
"""

import jax
import numpy as np
import pytest
import torch
from scipy import sparse
from scipy import stats as sp_stats

import sisua_tpu.data.utils as JU
import sisua_tpu.models as J
from sisua_tpu.data import generate_synthetic
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.data import utils as TU
from sisua_tpu_torch.models import base as TB
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


CLOSE = dict(rtol=1e-12, atol=0)
EXACT = ("proba_de", "proba_m1")
S = 3


@pytest.fixture(scope="module")
def sco():
  s = generate_synthetic(n_cells=240, n_genes=30, n_proteins=4,
                         n_celltypes=3, seed=7)
  ct = np.argmax(s.numpy("celltype"), axis=1)
  # the first cell's level is not the sorted first: level order is by
  # first appearance
  s.obs["ct"] = [f"type{(i + 2) % 3}" for i in ct]
  return s


# ------------------------------------------------------------- corruption
def _counts(seed=0, n=60, d=25):
  rng = np.random.default_rng(seed)
  return (rng.poisson(2.0, (n, d)) * (rng.uniform(size=(n, d)) > 0.4)
          ).astype(np.float32)


@pytest.mark.parametrize("distribution", ["binomial", "uniform"])
@pytest.mark.parametrize("seed", [8, 3])
def test_corruption_bitwise_dense(distribution, seed):
  x = _counts(seed)
  kw = dict(dropout=0.2, distribution=distribution, retain_rate=0.2,
            copy=True, seed=seed)
  want = JU.apply_artificial_corruption(x, **kw)
  got = TU.apply_artificial_corruption(x, **kw)
  assert got.dtype == want.dtype and (got != x).any()
  np.testing.assert_array_equal(got, want)
  assert TU.apply_artificial_corruption(x, dropout=0.0) is x


def test_corruption_bitwise_csr():
  x = sparse.csr_matrix(_counts(1))
  want = JU.apply_artificial_corruption(x, dropout=0.3, copy=True)
  got = TU.apply_artificial_corruption(x, dropout=0.3, copy=True)
  assert sparse.isspmatrix_csr(got)
  for f in ("data", "indices", "indptr"):
    np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
  with pytest.raises(ValueError, match="dropout"):
    TU.apply_artificial_corruption(x, dropout=1.0)
  with pytest.raises(ValueError, match="corruption"):
    TU.apply_artificial_corruption(x.toarray(), dropout=0.2,
                                   distribution="poisson")


def test_protein_names_as_jax():
  names = ["CD8a", "CD4-TotalSeqB", "PD-L1;CD274_control", " CD19 ",
           "IL7Ralpha;CD127", "CD3_TotalSeqA", "Ox40;CD134"]
  assert TU.standardize_protein_name(names) == \
      JU.standardize_protein_name(names)
  assert TU.standardize_protein_name("CD8A") == "CD8"
  with pytest.raises(TypeError):
    TU.standardize_protein_name(3)


# ------------------------------------------------ DE at the same draws
def _draws(x: np.ndarray) -> np.ndarray:
  """(S, m, d) float32 scales, a deterministic function of the rows."""
  lx = np.log1p(np.asarray(x, np.float32))
  out = []
  for s in range(S):
    z = lx * np.float32(1.0 + 0.3 * s) + np.float32(0.05 * s)
    e = np.exp(z - z.max(1, keepdims=True))
    out.append(e / e.sum(1, keepdims=True))
  return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def pair(sco):
  jm = J.SCVI(JRV(sco.n_vars, "nbd", name="rna"), seed=1)
  jm.get_normalized_expression = (
      lambda inputs, **kw: _draws(inputs.numpy()))
  tm = T.SCVI(TRV(sco.n_vars, "nbd", name="rna"), seed=1, device="cpu")
  tm._normalized_draws = lambda inputs, *a, **kw: iter(
      [torch.from_numpy(_draws(np.asarray(inputs)))])
  return jm, tm


def _assert_frame(got, df):
  for col in df.columns:
    if col == "group1":
      continue
    if col in EXACT:
      np.testing.assert_array_equal(got[col], df[col].values, err_msg=col)
    else:
      np.testing.assert_allclose(got[col], df[col].values, **CLOSE,
                                 err_msg=col)


CASES = {
    "change_rest": dict(group1="type0", mode="change", n_pairs=400,
                        max_cells=50, seed=3),
    "change_group2_small": dict(group1="type1", group2="type2",
                                mode="change", n_pairs=301, max_cells=500,
                                seed=0, delta=0.1),
    "vanilla_group2": dict(group1="type2", group2="type0", mode="vanilla",
                           n_pairs=400, max_cells=40, seed=5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_de_matches_jax_at_the_same_draws(sco, pair, case):
  jm, tm = pair
  kw = CASES[case]
  df = jm.differential_expression(sco, "ct", sample_shape=(S,), **kw)
  genes = list(np.asarray(sco.var_names, str))
  got = tm.differential_expression(sco.numpy(), sco.obs["ct"].values,
                                   sample_shape=(S,), var_names=genes, **kw)
  assert list(got) == ["gene"] + list(df.columns)
  assert list(got["gene"]) == list(df.index)
  _assert_frame(got, df)


def test_de_one_vs_rest_in_first_appearance_order(sco, pair):
  jm, tm = pair
  kw = dict(mode="change", sample_shape=(S,), n_pairs=200, max_cells=30,
            seed=2)
  df = jm.differential_expression(sco, "ct", **kw)
  labels = sco.obs["ct"].values
  got = tm.differential_expression(sco.numpy(), labels, **kw)
  levels = list(dict.fromkeys(labels))
  assert levels != sorted(levels)
  assert list(got) == list(df.columns)
  np.testing.assert_array_equal(got["group1"], df["group1"].values)
  assert list(dict.fromkeys(got["group1"])) == levels
  _assert_frame(got, df)


def test_de_errors_as_jax(sco, pair):
  jm, tm = pair
  x, labels = sco.numpy(), sco.obs["ct"].values
  for kw in (dict(group1="absent-level"), dict(group1="type0",
                                               group2="nope"),
             dict(group1="type0", mode="bayes")):
    with pytest.raises(ValueError) as want:
      jm.differential_expression(sco, "ct", sample_shape=(S,), **kw)
    with pytest.raises(ValueError) as got:
      tm.differential_expression(x, labels, sample_shape=(S,), **kw)
    assert str(got.value) == str(want.value)
  with pytest.raises(ValueError, match="labels"):
    tm.differential_expression(x, labels[:-1], group1="type0")
  with pytest.raises(ValueError, match="var_names"):
    tm.differential_expression(x, labels, group1="type0",
                               sample_shape=(S,), var_names=["g"])


@pytest.mark.parametrize("mode", ["change", "vanilla"])
@pytest.mark.parametrize("n_pairs", [500, 499])
def test_card_statistics_equal_numpy(mode, n_pairs):
  """The float64 torch statistics the card runs, on CPU tensors."""
  rng = np.random.default_rng(n_pairs)
  s1 = rng.dirichlet(np.ones(40), size=90)
  s2 = rng.dirichlet(np.ones(40), size=70)
  s2[:, :5] = s1[:70, :5]  # ties: |lfc| = 0 and a > b false
  i1 = rng.integers(0, 90, n_pairs)
  i2 = rng.integers(0, 70, n_pairs)
  want = TB._de_stats_numpy(s1, s2, i1, i2, mode, 0.25)
  got = TB._de_stats_torch(torch.from_numpy(s1), torch.from_numpy(s2), i1,
                           i2, mode, 0.25)
  assert list(got) == list(want)
  for k in want:
    if k in EXACT:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-300,
                                 err_msg=k)


# --------------------------------------------------- end to end (CPU)
def _init_like_flax(jm):
  """Initial weights for the JAX model's flax tree: its init traced for
  the shapes only (running it costs ~10 s), kernels lecun-normal, biases
  and BatchNorm means 0, scales and variances 1."""
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(4)

  def leaf(path, s):
    name = path[-1].key
    if name == "kernel":
      return (rng.normal(0, 1, s.shape) / np.sqrt(s.shape[0])
              ).astype(np.float32)
    if name in ("scale", "var"):
      return np.ones(s.shape, np.float32)
    return np.zeros(s.shape, np.float32)
  return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def test_fit_from_converted_weights_tracks_empirical_lfc():
  sco = generate_synthetic(n_cells=800, n_genes=60, n_proteins=5,
                           n_celltypes=3, seed=7)
  ct = np.argmax(sco.numpy("celltype"), axis=1)
  labels = np.asarray([f"type{i}" for i in ct])
  conf = dict(latents=dict(dim=8, posterior="diag", name="latents"),
              encoder={"units": [32, 32], "batchnorm": True})
  jm = J.SCVI(JRV(sco.n_vars, "nbd", name="rna"), seed=1, **conf)
  tm = T.SCVI(TRV(sco.n_vars, "nbd", name="rna"), seed=1, device="cpu",
              **conf)
  tree = _init_like_flax(jm)
  tm.module.load_state_dict(convert.jax_to_torch(
      tm.module, tree["params"], tree["batch_stats"]))
  x = np.asarray(sco.numpy(), np.float32)
  tm.fit(x, epochs=8, batch_size=64)
  de = tm.differential_expression(x, labels, group1="type0",
                                  sample_shape=(5,), n_pairs=2000,
                                  max_cells=96, seed=3)
  for col in ("proba_de", "bayes_factor", "lfc_mean", "lfc_median",
              "lfc_std", "scale1", "scale2"):
    assert np.isfinite(de[col]).all() and de[col].shape == (60,), col
  g1 = labels == "type0"
  emp = (np.log2(x[g1].mean(0) + 1.0) - np.log2(x[~g1].mean(0) + 1.0))
  rho = sp_stats.spearmanr(emp, de["lfc_median"]).statistic
  assert rho > 0.5, rho

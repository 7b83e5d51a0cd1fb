"""The JAX public calls the port refused before (ROADMAP C2), each held
against the JAX call on the same inputs.

  * ``dist``: slicing a distribution indexes every parameter (equal to
    the JAX slice's parameters); ``prob``, ``stddev``, ``entropy`` and
    ``MultivariateNormalDiag.covariance`` at rtol 1e-6 (float32);
    ``sample_and_log_prob`` returns a draw of the right shape and its own
    log-probability (the draws themselves come from different streams);
  * ``analysis.streamline_classifier(mode=, seed=)``: the JAX keys, F1
    within 0.01 as ``test_torch_port_criticizer`` holds it (liblinear's
    coordinate descent against the port's exact solve);
  * ``data.get_library_size(X, return_log_count=True)``: equal;
  * ``SingleCellOMIC(duplicated_var=)``: the same var names either way;
  * ``ResultsSheet.summary`` (and ``str``, ``len``, indexing): the same
    text and the same posteriors;
  * PEAKVI's and MULTIVI's ``depth_logit`` method: the JAX method's value
    at converted weights (atol 1e-5), and the ``convert`` round trip of
    the JAX parameters, with the layer flax names ``depth_logit``, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu_torch.dist as TD
from sisua_tpu_torch import convert

from test_torch_port_multiome import _data, _jax_batch, _pair
from torch_port_threads import _one_thread  # noqa: F401

RNG = np.random.default_rng(16)
LOC = RNG.normal(size=(5, 4)).astype(np.float32)
SCALE = RNG.uniform(0.5, 2.0, (5, 4)).astype(np.float32)
LOGITS = RNG.normal(size=(5, 3)).astype(np.float32)
X = RNG.normal(size=(5, 4)).astype(np.float32)
CLOSE = dict(rtol=1e-6, atol=1e-6)


def _pairs():
  j, t = jnp.asarray, torch.tensor
  onehot = np.eye(3, dtype=np.float32)[[0, 2, 1, 1, 0]]
  return {
      "normal": (JD.Normal(j(LOC), j(SCALE)), TD.Normal(t(LOC), t(SCALE)),
                 X),
      "mvn_diag": (JD.MultivariateNormalDiag(j(LOC), j(SCALE)),
                   TD.MultivariateNormalDiag(t(LOC), t(SCALE)), X),
      "independent": (JD.Independent(JD.Normal(j(LOC), j(SCALE)), 1),
                      TD.Independent(TD.Normal(t(LOC), t(SCALE)), 1), X),
      "categorical": (JD.Categorical(j(LOGITS)), TD.Categorical(t(LOGITS)),
                      np.array([0, 2, 1, 1, 0], np.float32)),
      "onehot": (JD.OneHotCategorical(j(LOGITS)),
                 TD.OneHotCategorical(t(LOGITS)), onehot),
  }


def _leaves(d):
  return [v for v in vars(d).values() if isinstance(v, torch.Tensor)] + [
      x for v in vars(d).values() if isinstance(v, TD.Distribution)
      for x in _leaves(v)]


@pytest.mark.parametrize("name", ["normal", "mvn_diag", "independent",
                                  "categorical", "onehot"])
def test_distribution_calls_match_jax(name):
  jd, td, x = _pairs()[name]
  # slicing indexes every parameter
  js, ts = jd[1:3], td[1:3]
  assert type(ts) is type(td) and tuple(ts.batch_shape) == tuple(
      js.batch_shape)
  for a, b in zip(_leaves(ts), jax.tree_util.tree_leaves(js)):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  np.testing.assert_allclose(td.prob(torch.tensor(x)).numpy(),
                             np.asarray(jd.prob(jnp.asarray(x))), **CLOSE)
  np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()),
                             **CLOSE)
  if name in ("normal", "mvn_diag", "onehot"):
    np.testing.assert_allclose(td.stddev().numpy(),
                               np.asarray(jd.stddev()), **CLOSE)
  if name == "mvn_diag":
    np.testing.assert_allclose(td.covariance().numpy(),
                               np.asarray(jd.covariance()), **CLOSE)
  # (the JAX categorical's log_prob takes no sample dimensions)
  js_, jlp = jd.sample_and_log_prob(jax.random.key(0))
  for shape in ((), (2,)):
    s, lp = td.sample_and_log_prob(shape, torch.Generator().manual_seed(0))
    assert tuple(s.shape) == shape + tuple(js_.shape)
    assert tuple(lp.shape) == shape + tuple(jlp.shape)
    np.testing.assert_array_equal(lp.numpy(), td.log_prob(s).numpy())


def test_streamline_classifier_takes_mode_and_seed():
  import sisua_tpu.analysis as JA
  import sisua_tpu_torch.analysis as TA
  rng = np.random.default_rng(8)
  Z = rng.normal(size=(300, 5))
  y = np.stack([Z[:, 0] + 0.5 * rng.normal(size=300), Z[:, 1] - Z[:, 2]],
               1)
  want = JA.streamline_classifier(Z[:200], y[:200], Z[200:], y[200:],
                                  ["CD4", "CD8"], mode="ovr", seed=3)
  got = TA.streamline_classifier(Z[:200], y[:200], Z[200:], y[200:],
                                 ["CD4", "CD8"], mode="ovr", seed=3,
                                 device="cpu")
  for w, g in zip(want, got):
    assert list(g) == list(w)
    for k in w:
      assert abs(g[k] - w[k]) <= 0.01, k


def test_get_library_size_returns_log_counts_as_jax():
  from scipy import sparse

  from sisua_tpu.data.utils import get_library_size as jlib
  from sisua_tpu_torch.data import get_library_size as tlib
  x = RNG.poisson(3.0, (50, 20)).astype(np.float32)
  for a in (x, sparse.csr_matrix(x)):
    for flag in (False, True):
      want, got = jlib(a, return_log_count=flag), tlib(
          a, return_log_count=flag)
      assert len(want) == len(got) == (3 if flag else 2)
      for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
  got = tlib(torch.tensor(x), return_log_count=True)
  for w, g in zip(jlib(x, return_log_count=True), got):
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("duplicated", [False, True])
def test_single_cell_omic_duplicated_var_as_jax(duplicated):
  from sisua_tpu.data import SingleCellOMIC as JS
  from sisua_tpu_torch.data import SingleCellOMIC as TS
  x = RNG.poisson(2.0, (6, 4)).astype(np.float32)
  names = ["A", "B", "A", "A"]
  j = JS(x, gene_id=names, duplicated_var=duplicated)
  t = TS(x, gene_id=names, duplicated_var=duplicated)
  assert list(t.get_var_names()) == list(j.var_names)
  assert t.md5 == j.md5


def test_results_sheet_summary_as_jax():
  from sisua_tpu.analysis import Posterior as JP
  from sisua_tpu.analysis import ResultsSheet as JR
  from sisua_tpu.data import SingleCellOMIC as JS
  from sisua_tpu_torch.analysis import Posterior as TP
  from sisua_tpu_torch.analysis import ResultsSheet as TR
  x = np.ones((4, 3), np.float32)

  def fakes(cls, jax_side):
    out = []
    for name in ("sisua_x", "vae_x"):
      p = cls.__new__(cls)
      p._name = name
      if jax_side:
        sco = JS(x)
        sco.add_omic("proteomic", x)
        p.sco_original = sco
      else:
        p.data = {"transcriptomic": x, "proteomic": x}
      out.append(p)
    return out

  j, t = JR(*fakes(JP, True)), TR(*fakes(TP, False))
  assert t.summary() == j.summary() == str(t)
  assert len(t) == len(j) == 2 and repr(t) == repr(j)
  assert t["SISUA"].name == j["SISUA"].name == "sisua_x"
  assert t[1].name == j[1].name and [p.name for p in t] == [
      p.name for p in j]
  with pytest.raises(KeyError):
    t["scvi"]


@pytest.mark.parametrize("name", ["peakvi", "multivi"])
def test_depth_logit_method_and_checkpoint_names_as_jax(name):
  jm, tm = _pair(name)
  x = _data(name)
  jx = _jax_batch({"inputs": x})["inputs"]
  variables = {"params": jm._state.params}
  if jm._state.batch_stats is not None:
    variables["batch_stats"] = jm._state.batch_stats
  module_in = jx[0] if name == "peakvi" else jnp.concatenate(jx, -1)
  want = jm.module.apply(variables, module_in,
                         method=lambda m, v: m.depth_logit(v))
  tm.module.eval()
  with torch.no_grad():
    got = tm.module.depth_logit(torch.tensor(np.asarray(module_in)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  assert hasattr(tm.module, "depth_head") and callable(tm.module.depth_logit)
  # the flax tree keys the layer 'depth_logit'; the round trip is bitwise
  params, stats = convert.torch_to_jax(tm.module)
  assert "depth_logit" in params and "depth_head" not in params
  jparams = jax.device_get(jm._state.params)
  assert set(params) == set(jparams)
  for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
    keys = [p.key for p in path]
    node = params
    for k in keys:
      node = node[k]
    np.testing.assert_array_equal(node, np.asarray(leaf))
  back = convert.jax_to_torch(tm.module, params, stats)
  for k, v in tm.module.state_dict().items():
    assert torch.equal(back[k], v), k
  assert convert.flax_param_path(tm.module, "depth_head.weight") == (
      "depth_logit", "kernel")

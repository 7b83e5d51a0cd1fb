"""The port's SOLO and CellAssign against the JAX package.

SOLO: ``_simulate_doublets`` bit-equal (the same numpy draws, summed where
the data lies), ``_embed`` of a converted SCVI (rtol 1e-5), one classifier
Adam step with JAX's dropout masks fed (``masks=``, read back from flax's
``Dropout_i`` outputs; loss rtol 1e-5, updated parameters rtol 1e-5, atol
1e-7), a CPU fit (the model frozen), and the mirrored finding that nothing
trains when the validation rows take every row (the JAX value: its
classifier keeps its initial parameters).

CellAssign: a whole small fit from the same numpy batch order (the epoch
losses rtol 1e-4, the fitted parameters and responsibilities rtol 1e-3 /
atol 1e-4, the hard labels equal), ``_size_factors`` with and without
enough unmarked genes, and its two mirrored findings: the shrinkage
penalty falls on ``delta_raw``, and ``predict`` normalizes the size
factors over the prediction set.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.models import solo as jsolo
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models import solo as tsolo
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, N = 20, 48
SCVI_KW = dict(latents=dict(dim=4, posterior="diag", name="latents"),
               encoder={"units": [16], "batchnorm": True},
               encoder_l={"units": [8], "batchnorm": True},
               decoder={"units": [16], "batchnorm": True})


def _counts(n=N, seed=0, g=G):
  rng = np.random.default_rng(seed)
  return (rng.poisson(np.exp(rng.normal(0.0, 1, (n, g))))
          * (rng.uniform(size=(n, g)) > 0.3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scvi():
  """A JAX SCVI with random weights (its flax init traced for shapes)."""
  jm = J.SCVI(JRV(G, "zinbd", name="rna"), seed=1, **SCVI_KW)
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(4)

  def leaf(path, s):
    name = path[-1].key
    if name == "var":
      return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
    if name == "scale":
      return (1.0 + rng.normal(0, 0.2, s.shape)).astype(np.float32)
    return rng.normal(0, 0.3, s.shape).astype(np.float32)
  tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
  jm._state = TrainState(step=jnp.zeros((), jnp.int32),
                         params=jax.tree_util.tree_map(jnp.asarray,
                                                       tree["params"]),
                         batch_stats=jax.tree_util.tree_map(
                             jnp.asarray, tree["batch_stats"]),
                         opt_state=None)
  return jm, tree["params"], tree["batch_stats"]


def _port_scvi():
  _, params, stats = _jax_scvi()
  tm = T.SCVI(TRV(G, "zinbd", name="rna"), device="cpu", seed=1, **SCVI_KW)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return tm


# --------------------------------------------------------------------- SOLO
def test_simulate_doublets_is_bit_equal():
  x = _counts()
  j = jsolo._simulate_doublets(x, 70, np.random.default_rng(3))
  t = tsolo._simulate_doublets(torch.tensor(x), 70, np.random.default_rng(3))
  np.testing.assert_array_equal(t.numpy(), j)


def test_embed_matches_jax():
  """Latent mean ⊕ log1p(library) of the frozen model, in batches."""
  x = _counts(seed=1)
  j = J.SOLO(_jax_scvi()[0])._embed(x, batch_size=16)
  t = T.SOLO(_port_scvi())._embed(torch.tensor(x), batch_size=16)
  assert t.shape == (N, 5) and t.dtype == np.float32
  np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_classifier_step_matches_jax():
  """One Adam step (lr 1e-3) of the classifier from the same parameters,
  with JAX's dropout masks: flax's ``Dropout_i`` outputs are read back
  and their nonzeros are the kept entries (a dropped and a zero entry
  give the same output)."""
  rng = np.random.default_rng(5)
  h = rng.normal(size=(32, 5)).astype(np.float32)
  y = rng.integers(0, 2, 32).astype(np.int32)
  clf = jsolo._Classifier((64, 32))
  params = clf.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 5)),
                    training=False)["params"]
  k = jax.random.PRNGKey(9)
  _, inter = clf.apply({"params": params}, h, training=True,
                       rngs={"dropout": k}, capture_intermediates=True,
                       mutable=["intermediates"])
  masks = [torch.tensor(np.asarray(
      inter["intermediates"][f"Dropout_{i}"]["__call__"][0]) != 0)
      for i in range(2)]
  tx = optax.adam(1e-3)

  def loss_fn(p):
    logits = clf.apply({"params": p}, h, training=True, rngs={"dropout": k})
    ll = jax.nn.log_softmax(logits, -1)
    return -jnp.mean(jnp.take_along_axis(ll, y[:, None], -1))
  loss, g = jax.value_and_grad(loss_fn)(params)
  updates, _ = tx.update(g, tx.init(params), params)
  new = jax.device_get(optax.apply_updates(params, updates))

  tc = tsolo._Classifier(5, (64, 32))
  tc.load_state_dict(convert.jax_to_torch(tc, jax.device_get(params)))
  assert sorted(dict(tc.named_children())) == ["Dense_0", "Dense_1",
                                                "Dense_2"]
  opt = torch.optim.Adam(tc.parameters(), lr=1e-3, eps=1e-8)
  solo = T.SOLO(_port_scvi())
  tl = solo._step(tc, opt, torch.tensor(h), torch.tensor(y, dtype=torch.long),
                  masks=masks)
  np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
  got = convert.torch_to_jax(tc)[0]
  for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(new),
                               jax.tree_util.tree_leaves_with_path(got)):
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-7,
                               err_msg=jax.tree_util.keystr(path))


def test_solo_untrained_when_validation_takes_every_row():
  """48 cells + 96 doublets < batch 256: ``n_valid`` = 256 takes every
  row, no step runs, and the classifier keeps its initial parameters in
  both packages (the JAX value, ADVICE finding, mirrored). With JAX's
  initial parameters the port's probabilities equal JAX's."""
  x = _counts(seed=2)
  js = J.SOLO(_jax_scvi()[0], seed=0).fit(x, epochs=2)
  init = jsolo._Classifier((64, 32)).init(
      {"params": jax.random.split(jax.random.PRNGKey(0))[1]},
      jnp.zeros((1, 5)), training=False)["params"]
  for a, b in zip(jax.tree_util.tree_leaves(js._params),
                  jax.tree_util.tree_leaves(init)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  ts = T.SOLO(_port_scvi(), seed=0).fit(torch.tensor(x), epochs=2)
  fresh = ts._new_classifier(5).state_dict()
  assert all(torch.equal(v, fresh[k])
             for k, v in ts.classifier.state_dict().items())
  np.testing.assert_allclose(ts._feat_mean, js._feat_mean, rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(ts._feat_std, js._feat_std, rtol=1e-5)
  ts.classifier.load_state_dict(convert.jax_to_torch(
      ts.classifier, jax.device_get(init)))
  np.testing.assert_allclose(ts.predict_doublet_proba(x),
                             js.predict_doublet_proba(x), rtol=1e-5,
                             atol=1e-6)


def test_solo_fit_trains_and_leaves_the_model_frozen():
  tm = _port_scvi()
  before = {k: v.clone() for k, v in tm.module.state_dict().items()}
  x = torch.tensor(_counts(n=96, seed=3))
  solo = T.SOLO.from_scvi_model(tm, seed=1)
  solo.fit(x, epochs=3, batch_size=16)
  assert all(torch.equal(v, before[k])
             for k, v in tm.module.state_dict().items())
  fresh = solo._new_classifier(5).state_dict()
  assert any(not torch.equal(v, fresh[k])
             for k, v in solo.classifier.state_dict().items())
  p = solo.predict(x)
  assert p.shape == (96,) and ((p >= 0) & (p <= 1)).all()
  assert np.array_equal(solo.predict(x, soft=False, threshold=0.5), p >= 0.5)
  with pytest.raises(RuntimeError, match="fit"):
    T.SOLO(tm).predict_doublet_proba(x)


# --------------------------------------------------------------- CellAssign
C = 3


def _panel(n_background=4):
  """(genes, types) markers: 3 per type, ``n_background`` unmarked."""
  g = 3 * C + n_background
  rho = np.zeros((g, C), np.float32)
  for c in range(C):
    rho[3 * c:3 * c + 3, c] = 1.0
  return rho


def _planted(rho, n=96, seed=0):
  """NB counts around log μ = log s + β + 1.5·ρ of each cell's type."""
  rng = np.random.default_rng(seed)
  types = rng.integers(0, C, n)
  s = np.exp(rng.normal(0, 0.3, n))
  beta = rng.normal(1.0, 0.5, rho.shape[0])
  mu = s[:, None] * np.exp(beta[None, :] + 1.5 * rho[:, types].T)
  x = rng.negative_binomial(5, 5 / (5 + mu)).astype(np.float32)
  return x, types, s.astype(np.float32)


def _params_np(params):
  return {k: np.asarray(v) for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _fits():
  rho = _panel()
  x, types, _ = _planted(rho)
  frame = pd.DataFrame(rho, index=[f"g{i}" for i in range(len(rho))],
                       columns=["T", "B", "NK"])
  jc = J.CellAssign(frame, seed=3).fit(x, epochs=5, batch_size=32)
  tc = T.CellAssign(frame, seed=3, device="cpu").fit(
      torch.tensor(x), epochs=5, batch_size=32)
  return jc, tc, x, types


def test_cellassign_fit_matches_jax():
  """Five epochs of three batches each, the same numpy batch order."""
  jc, tc, x, types = _fits()
  assert len(tc.history["loss"]) == 5
  np.testing.assert_allclose(tc.history["loss"], jc.history["loss"],
                             rtol=1e-4)
  jp, tp = _params_np(jc._params), _params_np(tc._params)
  for k in jp:
    np.testing.assert_allclose(tp[k], jp[k], rtol=1e-3, atol=1e-4,
                               err_msg=k)
  tg = tc.predict(x)
  np.testing.assert_allclose(tg, np.asarray(jc.predict(x)), rtol=1e-3,
                             atol=1e-4)
  assert tg.shape == (N * 2, C) and np.allclose(tg.sum(1), 1, atol=1e-5)
  hard = tc.predict(x, hard=True)
  assert list(hard) == list(jc.predict(x, hard=True))
  assert set(hard) <= {"T", "B", "NK"}
  np.testing.assert_allclose(tc.get_fold_changes(),
                             np.asarray(jc.get_fold_changes()), rtol=1e-3,
                             atol=1e-4)
  assert tc.celltypes == ["T", "B", "NK"] and tc.var_names[0] == "g0"
  fit_s = T.CellAssign(_panel(), seed=3, device="cpu")
  assert fit_s.celltypes is None


@pytest.mark.parametrize("n_background", [4, 2])
def test_cellassign_size_factors_match_jax(n_background):
  """From the unmarked genes when at least 3, else the whole panel."""
  rho = _panel(n_background)
  x, _, _ = _planted(rho, seed=1)
  j = J.CellAssign(rho)._size_factors(x)
  t = T.CellAssign(rho, device="cpu")._size_factors(torch.tensor(x))
  np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)


def test_cellassign_shrinkage_falls_on_delta_raw():
  """The penalty is shrinkage·Σ(delta_raw·ρ)², not on δ = δ_min +
  softplus(raw): the JAX value (ADVICE finding, mirrored)."""
  jc, tc, x, _ = _fits()
  rng = np.random.default_rng(8)
  params = dict(_params_np(jc._params))
  params["delta_raw"] = rng.normal(0, 2, params["delta_raw"].shape).astype(
      np.float32)
  log_s = jc._size_factors(x)
  j = float(jc._neg_llk(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x), jnp.asarray(log_s)))
  tparams = {k: torch.tensor(v) for k, v in params.items()}
  t = float(tc._neg_llk(tparams, torch.tensor(x), torch.tensor(log_s)))
  np.testing.assert_allclose(t, j, rtol=1e-5)
  tc0 = T.CellAssign(tc.rho.numpy(), shrinkage=0.0, device="cpu")
  penalty = t - float(tc0._neg_llk(tparams, torch.tensor(x),
                                   torch.tensor(log_s)))
  rho = tc.rho.numpy()
  np.testing.assert_allclose(penalty, 1e-3 * np.sum(
      (params["delta_raw"] * rho) ** 2), rtol=1e-3)


def test_cellassign_predict_size_factors_come_from_the_prediction_set():
  """Predicting 10 cells alone gives other responsibilities than the same
  cells inside the whole set: the JAX values (ADVICE finding, mirrored);
  given size factors, the two agree."""
  jc, tc, x, _ = _fits()
  sub = tc.predict(x[:10])
  whole = tc.predict(x)[:10]
  np.testing.assert_allclose(sub, np.asarray(jc.predict(x[:10])),
                             rtol=1e-3, atol=1e-4)
  assert np.abs(sub - whole).max() > 1e-4
  s = np.exp(jc._size_factors(x))
  np.testing.assert_allclose(tc.predict(x[:10], size_factors=s[:10]),
                             tc.predict(x, size_factors=s)[:10], rtol=1e-5,
                             atol=1e-6)

"""The port's TotalVI and SCANVI against the JAX package at converted
weights and fed noise: forward, loss, metrics and every parameter gradient
on both likelihood routes, with and without ``mask_protein`` and the batch
one-hot; serving (``predict``'s model latents, ``denoised_proteins``,
``marginal_log_prob``, ``decode`` at log β's posterior mean,
``predict_labels``); TotalVI's masked encoder input and low-budget
warning; CPU fits with validation.

Noise: both modules draw twice, as the JAX ones call ``make_rng('sample')``
twice per forward: the latents (the first key, split per latent), then
TotalVI's log β or SCANVI's z₂ (the second key). Both keys are read back
through the same ``apply`` and the draws redone. Serving replays the
model's key stream per batch and recovers each draw as (z − loc)/scale.
Dropout is 0 where outputs are compared; BatchNorm runs on batch stats.
Tolerances as tests/test_torch_port_zoo.py: loss and metrics rtol 1e-4;
gradients rtol 1e-4 with an atol of 1e-4·(largest |gradient| of the
model); served values rtol 1e-4, atol 1e-5.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import dist as D
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import BatchNorm
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, C, B, NB = 40, 5, 4, 32, 3
CLOSE = dict(rtol=1e-4, atol=1e-5)
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})
LAT = dict(dim=6, posterior="diag", name="latents")
SCANVI_NETS = dict(NETS, encoder_l={"units": [16], "batchnorm": True},
                   classifier={"units": [16]}, encoder_z2={"units": [16]},
                   decoder_z1={"units": [16]})

# name → (class, outputs [(dim, posterior, name)], constructor kwargs,
#         whether the data carries the batch one-hot)
CASES = {
    "totalvi": ("TotalVI", [(G, "zinbd", "rna"), (P, "nbd", "adt")],
                dict(NETS, latents=LAT), False),
    "totalvi_mask": ("TotalVI", [(G, "zinbd", "rna"), (P, "nbd", "adt")],
                     dict(NETS, latents=LAT, mask_protein=True, n_batch=NB),
                     True),
    "scanvi": ("SCANVI", [(G, "zinbd", "rna"), (C, "onehot", "celltype")],
               dict(SCANVI_NETS, latents=LAT), False),
    "scanvi_nb": ("SCANVI", [(G, "nbd", "rna"), (C, "onehot", "celltype")],
                  dict(SCANVI_NETS, latents=LAT, n_batch=NB), True),
}


def _build(name, RV, zoo, **extra):
  cls, outs, kw, _ = CASES[name]
  return getattr(zoo, cls)([RV(d, p, name=n) for d, p, n in outs], **kw,
                           **extra)


def _np_tree(tree):
  return None if tree is None else jax.tree_util.tree_map(
      np.asarray, jax.device_get(tree))


def _data(name, seed=0, n=B):
  """Numpy inputs: counts, protein counts or a cell-type one-hot, the
  batch one-hot where the case takes it."""
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  if CASES[name][0] == "TotalVI":
    y = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P)))).astype(
        np.float32)
  else:
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
  onehot = np.eye(NB, dtype=np.float32)[rng.integers(0, NB, n)]
  return [x, y] + ([onehot] if CASES[name][3] else [])


def _library(x):
  logc = np.log(x.sum(1) + 1e-8)
  return np.stack([np.full(len(x), logc.mean()),
                   np.full(len(x), logc.var())], 1).astype(np.float32)


def _batch(name, seed=0, n=B):
  inputs = _data(name, seed, n)
  mask = (np.random.default_rng(seed + 1).uniform(size=n) < 0.4)
  return {"inputs": inputs, "mask": mask.astype(np.float32),
          "library": _library(inputs[0])}


def _jax_batch(b):
  return {k: ([jnp.asarray(a) for a in v] if k == "inputs"
              else jnp.asarray(v)) for k, v in b.items()}


def _torch_batch(b):
  return {k: ([torch.tensor(a) for a in v] if k == "inputs"
              else torch.tensor(v)) for k, v in b.items()}


def _random_state(jm, seed=11):
  """Random (params, batch_stats) in the layout of ``jm``'s module: the
  flax init is traced for its shapes only (running it costs seconds);
  TotalVI's zero-init protein parameters are off zero too."""
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(seed)

  def leaf(path, s):
    name = path[-1].key
    if name == "var":
      a = rng.uniform(0.5, 1.5, s.shape)
    elif name == "kernel":
      a = rng.normal(0, 1 / np.sqrt(s.shape[0]), s.shape)
    elif name == "scale":
      a = 1.0 + rng.normal(0, 0.2, s.shape)
    else:
      a = rng.normal(0, 0.2, s.shape)
    return a.astype(np.float32)
  tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
  return tree["params"], tree.get("batch_stats")


def _set_state(jm, params, stats):
  jm._state = TrainState(
      step=jnp.zeros((), jnp.int32),
      params=jax.tree_util.tree_map(jnp.asarray, params),
      batch_stats=None if stats is None
      else jax.tree_util.tree_map(jnp.asarray, stats), opt_state=None)
  return jm


@functools.lru_cache(maxsize=None)
def _weights(name):
  """A JAX model of the case and random params and batch stats."""
  jm = _build(name, JRV, J)
  return (jm,) + _random_state(jm)


def _pair(name, seed=5):
  """A JAX model and a port model holding the same weights."""
  _, params, stats = _weights(name)
  jm = _set_state(_build(name, JRV, J, seed=seed), params, stats)
  tm = _build(name, TRV, T, device="cpu", seed=seed)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return jm, tm


def _second_draw_shape(jm, latents, z1):
  """Shape of the forward's second draw: TotalVI's log β (the nuisance
  latent's), SCANVI's z₂ ([C, *z₁ lead, dz])."""
  if isinstance(jm, J.TotalVI):
    q = latents[jm.n_latents]
    return tuple(q.batch_shape) + tuple(q.event_shape)
  return (jm.n_labels,) + tuple(z1.shape)


def _replayed_noise(jm, variables, x, rngs, out):
  """The three draws of one JAX forward with ``rngs``."""
  k1, k2 = jm.module.apply(
      variables, x, rngs=rngs,
      method=lambda m, *a, **k: (m.make_rng("sample"), m.make_rng("sample")))
  n = jm.n_latents
  lat = out.latents[:n]
  noise = [jax.random.normal(k, tuple(q.batch_shape) + tuple(q.event_shape))
           for q, k in zip(lat, jax.random.split(k1, n))]
  noise.append(jax.random.normal(k2, _second_draw_shape(
      jm, out.latents, out.latent_samples[0])))
  return [torch.tensor(np.asarray(e)) for e in noise]


def _port_grad_tree(module):
  """Parameter gradients in the flax layout (kernels transposed)."""
  out = {}
  for key, p in module.named_parameters():
    *owner, leaf = key.split(".")
    g = p.grad.numpy()
    if leaf == "weight":
      if isinstance(module.get_submodule(".".join(owner)), BatchNorm):
        leaf = "scale"
      else:
        leaf, g = "kernel", g.T
    node = out
    for o in owner:
      node = node.setdefault(o, {})
    node[leaf] = g
  return out


@functools.lru_cache(maxsize=None)
def _jax_side(name, training=True):
  jm, params, bs = _weights(name)
  batch = _jax_batch(_batch(name))
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  (loss, (metrics, _, out)), grads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=training),
      has_aux=True))(pj)
  k1, k2 = jax.random.split(key)
  x = jm._masked_module_input(batch, training)
  noise = _replayed_noise(jm, {"params": pj, "batch_stats": bs}, x,
                          {"sample": k1, "dropout": k2}, out)
  return dict(loss=float(loss), metrics=jax.device_get(metrics), out=out,
              grads=jax.device_get(grads), noise=noise)


def _run_port(name, mode, noise, training=True):
  _, tm = _pair(name)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    loss, metrics, out = tm._loss(_torch_batch(_batch(name)), training, 1.0,
                                  noise=noise)
    loss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module), model=tm)


# ------------------------------------------------------------ model parity
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
  """Output means (the protein mixture and the cell-type probabilities
  too), latent means and draws, TotalVI's q(log β) and SCANVI's per-class
  hierarchy penalty, train mode, same draws."""
  j = _jax_side(name)
  t = _run_port(name, "off", j["noise"])
  close = functools.partial(np.testing.assert_allclose, **CLOSE)
  for jp, tp in zip(j["out"].outputs, t["out"].outputs):
    assert type(tp.base if isinstance(tp, D.Independent) else tp).__name__ \
        == type(jp.base if hasattr(jp, "base") else jp).__name__
    close(tp.mean().detach().numpy(), np.asarray(jp.mean()))
  assert len(t["out"].latents) == len(j["out"].latents)
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    close(tq.mean().detach().numpy(), np.asarray(jq.mean()))
  for jz, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz))
  assert len(t["out"].aux_outputs) == len(j["out"].aux_outputs)
  for ja, ta in zip(j["out"].aux_outputs, t["out"].aux_outputs):
    close(ta.detach().numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["off", "on"],
                         ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name, mode):
  """Loss and metrics (TotalVI's background KL ``klqp_z2``, SCANVI's
  ``klqp_hierarchy`` and ``kl_y``) rtol 1e-4; every parameter gradient
  rtol 1e-4 with an atol of 1e-4·(largest |gradient| of the model)."""
  j = _jax_side(name)
  t = _run_port(name, mode, j["noise"])
  np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
  assert set(t["metrics"]) == set(j["metrics"])
  for k in j["metrics"]:
    np.testing.assert_allclose(float(t["metrics"][k].detach()),
                               float(j["metrics"][k]), rtol=1e-4, atol=1e-6,
                               err_msg=k)
  jl = jax.tree_util.tree_leaves_with_path(j["grads"])
  tl = jax.tree_util.tree_leaves_with_path(t["grads"])
  assert [p for p, _ in jl] == [p for p, _ in tl]
  scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jl)
  for (path, jg), (_, tg) in zip(jl, tl):
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale,
                               err_msg=jax.tree_util.keystr(path))
  if CASES[name][0] == "TotalVI":
    assert "klqp_z2" in t["metrics"]
  else:
    assert {"klqp_hierarchy", "kl_y"} <= set(t["metrics"])


@pytest.mark.parametrize("name", ["totalvi_mask", "scanvi"])
def test_eval_loss_matches_jax(name):
  """Eval mode: the mask is ignored (every cell labeled), BatchNorm reads
  its running stats, the protein slice is not zeroed."""
  j = _jax_side(name, training=False)
  t = _run_port(name, "off", j["noise"], training=False)
  np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
  for k in j["metrics"]:
    np.testing.assert_allclose(float(t["metrics"][k].detach()),
                               float(j["metrics"][k]), rtol=1e-4, atol=1e-6,
                               err_msg=k)


def test_mask_protein_zeroes_unlabeled_proteins_in_training_only():
  _, tm = _pair("totalvi_mask")
  b = _torch_batch(_batch("totalvi_mask"))
  x = tm._masked_module_input(b, training=True)
  assert x.shape == (B, G + P + NB)
  unl = b["mask"] == 0
  assert unl.any() and (~unl).any()
  assert torch.equal(x[unl, G:G + P], torch.zeros(int(unl.sum()), P))
  assert torch.equal(x[~unl, G:G + P], b["inputs"][1][~unl])
  assert torch.equal(x[:, G + P:], b["inputs"][2])
  assert torch.equal(tm._masked_module_input(b, training=False),
                     tm._module_input(b["inputs"]))
  _, plain = _pair("totalvi")
  assert torch.equal(plain._masked_module_input(b, training=True)[:, G:],
                     b["inputs"][1])


def test_totalvi_low_budget_warning():
  jm, tm = _pair("totalvi_mask")
  data = _data("totalvi_mask", n=64)
  with pytest.warns(UserWarning, match="mask_renorm"):
    tm.fit(data, epochs=1, batch_size=32, labels_percent=0.05,
           device_cache=True)
  assert tm.is_semi_supervised and tm.mask_protein
  _, unmasked = _pair("totalvi")
  assert not unmasked.is_semi_supervised


def test_models_resolve_by_name_and_id():
  assert T.get_model("totalvi") is T.get_model("tvi") is T.TotalVI
  assert T.get_model("SCANVI") is T.get_model("scanvi") is T.SCANVI
  m = _build("scanvi", TRV, T, device="cpu", labels=TRV(7, "nb",
                                                         name="celltype"))
  assert m.outputs[1].posterior == "onehot" and m.outputs[1].projection
  assert m.n_labels == 7 and m.alpha == 50.0
  with pytest.raises(ValueError, match="exactly"):
    T.TotalVI(TRV(G, "zinbd", name="rna"), device="cpu")


# ------------------------------------------------------------- serving
def _stream_keys(rng, k):
  keys = []
  for _ in range(k):
    rng, sub = jax.random.split(rng)
    keys.append(sub)
  return keys


@functools.lru_cache(maxsize=None)
def _serving_apply(name, sample_shape):
  """JAX's serving forward of a case, compiled once."""
  module = _weights(name)[0].module
  return jax.jit(lambda v, x, key, lib: module.apply(
      v, x, rngs={"sample": key}, training=False, sample_shape=sample_shape,
      library=lib))


def _jax_draws(name, jm, data, sample_shape=(), batch=B):
  """The eps JAX's streaming serving call on ``data`` draws, batch by
  batch, grouped as the port's module draws them: [[z, l], [second]]."""
  n = len(data[0])
  k = -(-n // batch)
  variables = {"params": jm.params, "batch_stats": jm.batch_stats}
  lib = _library(data[0])
  apply = functools.partial(_serving_apply(name, sample_shape), variables)
  draws = []
  for i, key in enumerate(_stream_keys(jm._rng, k)):
    rows = slice(i * batch, (i + 1) * batch)
    x = jm._module_input([jnp.asarray(a[rows]) for a in data])
    out = apply(x, key, jnp.asarray(lib[rows]))
    if isinstance(jm, J.TotalVI):
      eps = [torch.tensor(np.asarray((z - q.mean()) / jnp.sqrt(
          q.variance()))) for q, z in zip(out.latents, out.latent_samples)]
    else:
      eps = _replayed_noise(jm, variables, x, {"sample": key}, out)
    draws.append([eps[:2], eps[2:]])
  return draws


@contextlib.contextmanager
def _fed(tm, draws):
  """The port's module takes ``draws`` in order: two draws per batch."""
  it = iter(d for per_batch in draws for d in per_batch)
  sample = type(tm.module)._sample
  tm.module._sample = lambda qZ, ss, gen, noise: sample(
      tm.module, qZ, ss, gen, next(it))
  try:
    yield
    assert next(it, None) is None, "fewer draws taken than made"
  finally:
    del tm.module._sample


@pytest.mark.parametrize("name", ["totalvi", "totalvi_mask"])
def test_totalvi_predict_and_denoised_proteins_match_jax(name):
  """``predict`` returns the model's two latents, not q(log β), as JAX;
  the merged protein mixture and ``denoised_proteins`` (in [0, 1]) equal
  JAX's at the same draws (70 cells: the last batch ragged)."""
  jm, tm = _pair(name)
  data = _data(name, seed=4, n=70)
  draws = _jax_draws(name, jm, data)
  jX, jZ = jm.predict(data, batch_size=B)
  with _fed(tm, draws):
    tX, tZ = tm.predict(data, batch_size=B)
  assert len(tZ) == len(jZ) == 2
  for t, j in zip(tX + tZ, jX + jZ):
    np.testing.assert_allclose(t.mean().numpy(), np.asarray(j.mean()),
                               **CLOSE)
  assert isinstance(tX[1].base, D.NegativeBinomialMixture)
  assert tuple(tX[1].base.disp.shape) == (70, P)
  draws = _jax_draws(name, jm, data)  # JAX's stream moved on
  jd = jm.denoised_proteins(data, batch_size=B)
  with _fed(tm, draws):
    td = tm.denoised_proteins(data, batch_size=B)
  assert td.shape == (70, P) and ((td >= 0) & (td <= 1)).all()
  np.testing.assert_allclose(td, np.asarray(jd), **CLOSE)


def test_totalvi_serving_cuts_the_nuisance_latent():
  """``predict`` (both paths), ``predict_mean`` and ``encode`` return
  (z, l); the forward still carries q(log β); ``marginal_log_prob`` sums
  all three latents and equals JAX's at the same draws."""
  jm, tm = _pair("totalvi_mask")
  data = _data("totalvi_mask", seed=6, n=40)
  for dc in (False, True):
    _, qZ = tm.predict(data, batch_size=16, device_cache=dc)
    assert len(qZ) == 2
  xm, zm = tm.predict_mean(data, batch_size=16)
  assert [a.shape for a in zm] == [(40, LAT["dim"]), (40, 1)]
  assert [a.shape for a in xm] == [(40, G), (40, P)]
  assert len(tm.encode(tm._module_input([torch.tensor(a) for a in data]),
                       library=_library(data[0]))) == 2
  out = tm.apply(tm._module_input([torch.tensor(a) for a in data]),
                 library=_library(data[0]))
  assert len(out.latents) == 3
  draws = _jax_draws("totalvi_mask", jm, data, (5,))
  j = jm.marginal_log_prob(data, sample_shape=5, batch_size=B)
  with _fed(tm, draws):
    t = tm.marginal_log_prob(data, sample_shape=5, batch_size=B)
  assert t.shape == (40,)
  np.testing.assert_allclose(t, np.asarray(j), **CLOSE)


def test_totalvi_decode_draws_nothing_and_matches_jax():
  """``decode`` puts log β at its posterior mean (JAX applies no 'sample'
  stream there) and takes nothing from the model's generator."""
  jm, tm = _pair("totalvi")
  rng = np.random.default_rng(8)
  z = [rng.normal(0, 1, (20, LAT["dim"])).astype(np.float32),
       rng.normal(3, 0.5, (20, 1)).astype(np.float32)]
  jX = jm.decode(z)
  state = tm.generator.get_state()
  with torch.no_grad():
    tX = tm.decode(z)
  assert torch.equal(tm.generator.get_state(), state)
  for t, j in zip(tX, jX):
    np.testing.assert_allclose(t.mean().numpy(), np.asarray(j.mean()),
                               **CLOSE)


@pytest.mark.parametrize("hard", [False, True])
def test_scanvi_predict_labels_matches_jax(hard):
  """q(y|z̄₁) at the posterior mean, probabilities or class indices."""
  jm, tm = _pair("scanvi_nb")
  data = _data("scanvi_nb", seed=7, n=70)
  j = np.asarray(jm.predict_labels(data, batch_size=B, hard=hard))
  t = tm.predict_labels(data, batch_size=B, hard=hard)
  assert t.shape == ((70,) if hard else (70, C))
  if hard:
    np.testing.assert_array_equal(t, j)
  else:
    np.testing.assert_allclose(t, j, **CLOSE)
    np.testing.assert_allclose(t.sum(-1), 1.0, rtol=1e-5)


def test_scanvi_predict_mean_gives_class_probabilities():
  """Output 1's mean is q(y|z₁)'s probabilities, as JAX's, at the same
  draws (they reach the classifier through z₁)."""
  jm, tm = _pair("scanvi")
  data = _data("scanvi", seed=9, n=40)
  draws = _jax_draws("scanvi", jm, data, batch=40)
  jx, _ = jm.predict(data, batch_size=40)
  with _fed(tm, draws):
    tx, _ = tm.predict(data, batch_size=40)
  probs = tx[1].mean().numpy()
  np.testing.assert_allclose(probs, np.asarray(jx[1].mean()), **CLOSE)
  np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


# ----------------------------------------------------------------- fitting
@pytest.mark.parametrize("name", ["totalvi_mask", "scanvi"])
def test_fit_with_valid_on_cpu(name):
  """``fit(train, valid=…)``: finite, falling loss, the model's own keys in
  the history; evaluate finite; no kernel launched off the card."""
  data = _data(name, seed=3, n=192)
  m = _build(name, TRV, T, device="cpu")
  tz.reset_launches()
  m.fit([a[:160] for a in data], valid=[a[160:] for a in data], epochs=4,
        batch_size=32, learning_rate=3e-3, metrics_interval=2,
        labels_percent=0.5, device_cache=True)
  h = m.history
  assert len(h["loss"]) == 4 and len(h["val_loss"]) == 2
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert np.isfinite(h["val_loss"]).all()
  own = {"klqp_z2"} if name.startswith("totalvi") else {"klqp_hierarchy",
                                                        "kl_y"}
  assert own <= set(h) and {f"val_{k}" for k in own} <= set(h)
  ev = m.evaluate([a[160:] for a in data], batch_size=24)
  assert np.isfinite(list(ev.values())).all()
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}

"""The port's PEAKVI and MULTIVI against the JAX package at converted
weights and fed noise: ``_compose_logits``; the ELBO's missing-modality
gates (``output_masks``, ``latent_masks``); forward, loss, every metric
and every parameter gradient on both likelihood routes, on paired, mosaic
(paired, RNA-only, ATAC-only and neither-modality rows) and ATAC-only
batches, with and without the batch one-hot; serving (two latents, the
per-gene θ row, accessibility estimates, ``marginal_log_prob``);
checkpoints both ways; CPU fits.

Noise: both modules call ``make_rng('sample')`` once per forward and split
the key per latent (MULTIVI draws z from the joint posterior and l from
the library head; its experts' "samples" are their means). The key is
read back through the same ``apply`` and the draws redone. Serving replays
the model's key stream per batch and recovers each draw as
(z − loc)/scale. Dropout is 0 where outputs are compared; BatchNorm runs
on batch stats in training. Tolerances as
tests/test_torch_port_totalvi_scanvi.py: loss and metrics rtol 1e-4;
gradients rtol 1e-4 with an atol of 1e-4·(largest |gradient| of the
model); served values rtol 1e-4, atol 1e-5; ``_compose_logits`` atol 1e-6.
"""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.models import objective as jobj
from sisua_tpu.models.module import VAEOutput as JOut
from sisua_tpu.models.peakvi import _compose_logits as j_compose
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models import objective as tobj
from sisua_tpu_torch.models.module import VAEOutput as TOut
from sisua_tpu_torch.models.peakvi import _compose_logits as t_compose
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, R, B, NB = 40, 60, 32, 3
CLOSE = dict(rtol=1e-4, atol=1e-5)
LAT = dict(dim=6, posterior="diag", name="latents")
PEAK_NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
                 decoder={"units": [32, 32], "batchnorm": True},
                 depth={"units": [8]}, latents=LAT)
# unequal widths per modality, so a head read from the wrong branch fails
MULTI_NETS = dict(encoder=({"units": [32, 32], "batchnorm": True},
                           {"units": [32, 16], "batchnorm": True}),
                  decoder=({"units": [32, 32], "batchnorm": True},
                           {"units": [16, 32], "batchnorm": True}),
                  depth={"units": [8]}, latents=LAT)

# name → (class, outputs [(dim, posterior, name)], kwargs, batch one-hot?)
CASES = {
    "peakvi": ("PEAKVI", [(R, "zinb", "atac")], PEAK_NETS, False),
    "peakvi_b": ("PEAKVI", [(R, "bernoulli", "atac")],
                 dict(PEAK_NETS, n_batch=NB), True),
    "multivi": ("MULTIVI", [(G, "zinbd", "rna"), (R, "bernoulli", "atac")],
                MULTI_NETS, False),
    "multivi_b": ("MULTIVI", [(G, "nbd", "rna"), (R, "bernoulli", "atac")],
                  dict(MULTI_NETS, n_batch=NB, modality_penalty=2.0), True),
}


def _build(name, RV, zoo, **extra):
  cls, outs, kw, _ = CASES[name]
  return getattr(zoo, cls)([RV(d, p, name=n) for d, p, n in outs], **kw,
                           **extra)


def _data(name, seed=0, n=B, kind="mosaic"):
  """Numpy inputs: [atac] for PEAKVI, [rna, atac] for MULTIVI (then the
  batch one-hot where the case takes it). Peak counts 1–4+ at ~30%, so
  binarizing changes them; every row holds counts unless ``kind`` removes
  them: 'mosaic' zeroes the RNA of rows 0–5 (ATAC-only), the ATAC of rows
  6–11 (RNA-only) and both of rows 12–14; 'atac_only' every RNA row."""
  rng = np.random.default_rng(seed)
  atac = (rng.poisson(1.5, (n, R)) * (rng.uniform(size=(n, R)) < 0.3)
          ).astype(np.float32)
  atac[:, 0] = np.maximum(atac[:, 0], 2.0)
  onehot = np.eye(NB, dtype=np.float32)[rng.integers(0, NB, n)]
  tail = [onehot] if CASES[name][3] else []
  if CASES[name][0] == "PEAKVI":
    return [atac] + tail
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  x[:, 0] += 1.0
  if kind == "mosaic":
    x[0:6] = 0.0
    atac[6:12] = 0.0
    x[12:15] = 0.0
    atac[12:15] = 0.0
  elif kind == "atac_only":
    x[:] = 0.0
  return [x, atac] + tail


def _library(x):
  logc = np.log(x.sum(1) + 1e-8)
  return np.stack([np.full(len(x), logc.mean()),
                   np.full(len(x), logc.var())], 1).astype(np.float32)


def _batch(name, kind="mosaic", seed=0, n=B):
  """One batch; its library statistics are those of the mosaic data the
  batch would come from (an all-ATAC matrix has log-count variance 0, a
  zero prior scale and a NaN library KL, which JAX's jit turns into 0 and
  its eager mode into NaN, as the port)."""
  inputs = _data(name, seed, n, kind)
  return {"inputs": inputs, "mask": np.ones(n, np.float32),
          "library": _library(_data(name, seed, n)[0])}


def _jax_batch(b):
  return {k: ([jnp.asarray(a) for a in v] if k == "inputs"
              else jnp.asarray(v)) for k, v in b.items()}


def _torch_batch(b):
  return {k: ([torch.tensor(a) for a in v] if k == "inputs"
              else torch.tensor(v)) for k, v in b.items()}


def _random_state(jm, seed=11):
  """Random (params, batch_stats) in the layout of ``jm``'s module: the
  flax init is traced for its shapes only; the zero-init region factor
  and per-gene dispersion are off zero too."""
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
  jm = _build(name, JRV, J)
  return (jm,) + _random_state(jm)


def _pair(name, seed=5):
  """A JAX model and a port model holding the same weights."""
  _, params, stats = _weights(name)
  jm = _set_state(_build(name, JRV, J, seed=seed), params, stats)
  tm = _build(name, TRV, T, device="cpu", seed=seed)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return jm, tm


def _noise(jm, latents, key):
  """The draws of the forward's one 'sample' key, split per latent."""
  n = jm.n_latents
  return [torch.tensor(np.asarray(jax.random.normal(
      k, tuple(q.batch_shape) + tuple(q.event_shape))))
      for q, k in zip(latents[:n], jax.random.split(key, n))]


def _replayed_noise(jm, variables, x, rngs, out):
  key = jm.module.apply(variables, x, rngs=rngs,
                        method=lambda m, *a, **k: m.make_rng("sample"))
  return _noise(jm, out.latents, key)


def _port_grad_tree(module):
  """Parameter gradients in the flax layout (kernels transposed)."""
  out = {}
  for key, p in module.named_parameters():
    *owner, leaf = convert.flax_param_path(module, key)
    g = p.grad.numpy()
    if leaf == "kernel":
      g = g.T
    node = out
    for o in owner:
      node = node.setdefault(o, {})
    node[leaf] = g
  return out


@functools.lru_cache(maxsize=None)
def _jax_loss(name, training):
  """JAX's loss and gradient of a case, compiled once for every batch."""
  jm, _, bs = _weights(name)
  return jax.jit(jax.value_and_grad(
      lambda p, batch, key: jm._loss(p, bs, batch, key, 1.0,
                                     training=training), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_side(name, kind="mosaic", training=True):
  jm, params, bs = _weights(name)
  batch = _jax_batch(_batch(name, kind))
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  (loss, (metrics, _, out)), grads = _jax_loss(name, training)(pj, batch,
                                                               key)
  k1, k2 = jax.random.split(key)
  noise = _replayed_noise(jm, {"params": pj, "batch_stats": bs},
                          jm._module_input(batch["inputs"]),
                          {"sample": k1, "dropout": k2}, out)
  return dict(loss=float(loss), metrics=jax.device_get(metrics), out=out,
              grads=jax.device_get(grads), noise=noise)


@contextlib.contextmanager
def _route(mode):
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    yield
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old


def _run_port(name, kind, mode, noise, training=True):
  _, tm = _pair(name)
  with _route(mode):
    loss, metrics, out = tm._loss(_torch_batch(_batch(name, kind)), training,
                                  1.0, noise=noise)
    loss.backward()
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module), model=tm)


def _assert_loss_matches(t, j):
  np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
  assert set(t["metrics"]) == set(j["metrics"])
  for k in j["metrics"]:
    np.testing.assert_allclose(float(t["metrics"][k].detach()),
                               float(j["metrics"][k]), rtol=1e-4, atol=1e-6,
                               err_msg=k)


# --------------------------------------------------------- pieces
@pytest.mark.parametrize("factors", ["y", "y_d", "y_r", "y_d_r"])
def test_compose_logits_matches_jax(factors):
  """Seeded logits with ±30 and the −1e-7 clamp reached (three factors
  near 1: log p ≥ −1e-7), each missing factor taken as 1; atol 1e-6."""
  rng = np.random.default_rng(1)
  ly = rng.normal(0, 4, (16, 50)).astype(np.float32)
  ly[0, :4] = [30.0, -30.0, 30.0, -30.0]
  ld = rng.normal(0, 3, (16, 1)).astype(np.float32)
  ld[0] = 30.0
  lr = rng.normal(0, 3, (50,)).astype(np.float32)
  lr[:2] = [30.0, 30.0]
  args = [ly, ld if "d" in factors else None, lr if "r" in factors else None]
  j = np.asarray(j_compose(*[None if a is None else jnp.asarray(a)
                             for a in args]))
  t = t_compose(*[None if a is None else torch.tensor(a) for a in args])
  np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)
  assert np.isfinite(j).all()
  if factors in ("y", "y_d_r"):  # the clamp binds at (0, 0)
    assert j[0, 0] == pytest.approx(np.log(1e-7) * -1, rel=1e-3)


def _gated_outputs(D, Out, arr, rng):
  """A VAEOutput of two outputs (Poisson, Bernoulli) and two latents (a
  standard-normal prior, and None) from seeded parameters."""
  a = lambda *s: arr(rng.normal(0, 1, s).astype(np.float32))
  ones = lambda *s: arr(np.ones(s, np.float32))
  zeros = lambda *s: arr(np.zeros(s, np.float32))
  q0 = D.MultivariateNormalDiag(loc=a(8, 3), scale_diag=ones(8, 3) * 0.7)
  q1 = D.MultivariateNormalDiag(loc=a(8, 2), scale_diag=ones(8, 2) * 1.3)
  p0 = D.MultivariateNormalDiag(loc=zeros(3), scale_diag=ones(3))
  outs = (D.Independent(D.Poisson(rate=arr(np.exp(rng.normal(
      0, 1, (8, 5))).astype(np.float32))), 1),
          D.Independent(D.Bernoulli(logits=a(8, 4)), 1))
  return Out(outputs=outs, latents=(q0, q1), latent_samples=(a(8, 3),
                                                             a(8, 2)),
             priors=(p0, None))


@pytest.mark.parametrize("semi", [False, True], ids=["plain", "semi_mask"])
def test_gated_elbo_matches_jax(semi):
  """``elbo_terms`` and ``compute_loss`` with output gates (the main one
  gated too, a None entry), latent gates (shorter than the latents), α and
  the semi-supervised mask, against JAX: every term rtol 1e-5."""
  jout = _gated_outputs(JD, JOut, jnp.asarray, np.random.default_rng(2))
  tout = _gated_outputs(TD, TOut, torch.tensor, np.random.default_rng(2))
  rng = np.random.default_rng(3)
  y = [rng.poisson(1.0, (8, 5)).astype(np.float32),
       (rng.uniform(size=(8, 4)) < 0.4).astype(np.float32)]
  m_x = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
  m_z = np.array([0, 1, 1, 0, 1, 1, 1, 1], np.float32)
  mask = np.array([1, 1, 0, 1, 0, 0, 1, 1], np.float32)
  kw = dict(alpha=3.0, mask_outputs=semi, mask_renorm=semi)
  for f in ("elbo_terms", "compute_loss"):
    extra = {} if f == "elbo_terms" else dict(beta=0.5)
    j = getattr(jobj, f)(jout, [jnp.asarray(a) for a in y],
                         mask=jnp.asarray(mask),
                         output_masks=[jnp.asarray(m_x), None],
                         latent_masks=[jnp.asarray(m_z)], **kw, **extra)
    t = getattr(tobj, f)(tout, [torch.tensor(a) for a in y],
                         mask=torch.tensor(mask),
                         output_masks=[torch.tensor(m_x), None],
                         latent_masks=[torch.tensor(m_z)], **kw, **extra)
    jd = j if f == "elbo_terms" else (j[1],)
    td = t if f == "elbo_terms" else (t[1],)
    for jj, tt in zip(jd, td):
      assert set(jj) == set(tt)
      for k in jj:
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
  llk_t, kl_t = tobj.elbo_terms(tout, [torch.tensor(a) for a in y],
                                output_masks=[torch.tensor(m_x), None],
                                latent_masks=[torch.tensor(m_z)])
  assert (llk_t["llk_x"][m_x == 0] == 0).all()
  assert (kl_t["klqp_z"][m_z == 0] == 0).all()
  assert (kl_t["klqp_z1"] == 0).all()  # a None prior


# --------------------------------------------------------- model parity
LOSS_CASES = [("peakvi", "mosaic"), ("peakvi_b", "mosaic"),
              ("multivi", "paired"), ("multivi", "mosaic"),
              ("multivi", "atac_only"), ("multivi_b", "mosaic")]


@pytest.mark.parametrize("name", ["peakvi_b", "multivi", "multivi_b"])
def test_forward_matches_jax(name):
  """Output means (the RNA NB/ZINB and the composed Bernoulli), the four
  (MULTIVI) or one (PEAKVI) latents' means and samples, train mode, same
  draws, on a mosaic batch."""
  j = _jax_side(name)
  t = _run_port(name, "mosaic", "off", j["noise"])
  close = functools.partial(np.testing.assert_allclose, **CLOSE)
  assert len(t["out"].outputs) == len(j["out"].outputs)
  for jp, tp in zip(j["out"].outputs, t["out"].outputs):
    assert type(tp.base).__name__ == type(jp.base).__name__
    close(tp.mean().detach().numpy(), np.asarray(jp.mean()))
  assert len(t["out"].latents) == len(j["out"].latents)
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    close(tq.mean().detach().numpy(), np.asarray(jq.mean()))
  for jz, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz))
  assert [p is None for p in t["out"].priors] == \
      [p is None for p in j["out"].priors]


@pytest.mark.parametrize("mode", ["off", "on"], ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("name,kind", LOSS_CASES,
                         ids=[f"{n}-{k}" for n, k in LOSS_CASES])
def test_loss_and_gradients_match_jax(name, kind, mode):
  """Loss and metrics (MULTIVI's ``modality_penalty``, the gated
  ``llk_x``/``llk_x1`` and library KL ``klqp_z1``) rtol 1e-4; every
  parameter gradient rtol 1e-4 with an atol of 1e-4·(largest |gradient|).
  On the fused route MULTIVI's RNA head takes the fused op with a per-gene
  θ, and the gate gives the op's backward g = 0 on masked rows."""
  j = _jax_side(name, kind)
  t = _run_port(name, kind, mode, j["noise"])
  _assert_loss_matches(t, j)
  jl = jax.tree_util.tree_leaves_with_path(j["grads"])
  tl = jax.tree_util.tree_leaves_with_path(t["grads"])
  assert [p for p, _ in jl] == [p for p, _ in tl]
  scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jl)
  for (path, jg), (_, tg) in zip(jl, tl):
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale,
                               err_msg=jax.tree_util.keystr(path))
  if name.startswith("multivi"):
    assert "modality_penalty" in t["metrics"]
    assert "latent_head_latents" not in t["grads"]
  if kind == "atac_only":
    for k in ("klqp_z1", "llk_x", "modality_penalty"):
      assert float(t["metrics"][k].detach()) == 0.0, k


@pytest.mark.parametrize("name", ["peakvi_b", "multivi_b"])
def test_eval_loss_matches_jax(name):
  """Eval mode: BatchNorm reads its running stats and the missing-modality
  gates still apply."""
  j = _jax_side(name, training=False)
  t = _run_port(name, "mosaic", "off", j["noise"], training=False)
  _assert_loss_matches(t, j)


def _metrics(tm, x, a):
  with torch.no_grad():
    _, m, _ = tm._loss({"inputs": [torch.tensor(x), torch.tensor(a)]}, False,
                       1.0)
  return {k: float(v) for k, v in m.items()}


def test_library_kl_gated_and_penalty_per_paired_cell():
  """As tests/test_multivi.py for the JAX package: the library KL is 0 on
  an all-ATAC batch and halves when half the cells lose their RNA; the
  penalty of a half-paired batch equals the all-paired one's."""
  _, tm = _pair("multivi")
  x, a = _data("multivi", kind="paired")[:2]
  tm.generator.manual_seed(0)
  paired = _metrics(tm, x, a)
  assert paired["klqp_z1"] > 1e-6
  assert _metrics(tm, np.zeros_like(x), a)["klqp_z1"] == 0.0
  mixed = _metrics(tm, np.concatenate([x, np.zeros_like(x)]),
                   np.concatenate([a, a]))
  np.testing.assert_allclose(mixed["modality_penalty"],
                             paired["modality_penalty"], rtol=1e-4)
  np.testing.assert_allclose(mixed["klqp_z1"], 0.5 * paired["klqp_z1"],
                             rtol=1e-4)


def test_joint_posterior_takes_the_observed_expert():
  """The joint mean of an ATAC-only cell does not move when its (already
  zero) RNA block is fed as zeros; a paired cell's does; a cell with
  neither modality mixes the experts 0.5/0.5."""
  _, tm = _pair("multivi")
  x, a = _data("multivi", kind="mosaic")[:2]
  xin = np.concatenate([x, a], 1)
  q = tm.module.eval().encode(torch.tensor(xin))
  zeroed = xin.copy()
  zeroed[:, :G] = 0.0
  q0 = tm.module.encode(torch.tensor(zeroed))
  z, z0 = q[0].mean().detach().numpy(), q0[0].mean().detach().numpy()
  np.testing.assert_array_equal(z[:6], z0[:6])     # ATAC-only rows
  assert np.abs(z[15:] - z0[15:]).max() > 1e-3     # paired rows
  q_r, q_a = q[2], q[3]
  np.testing.assert_allclose(
      z[12:15], 0.5 * (q_r.loc[12:15] + q_a.loc[12:15]).detach().numpy(),
      rtol=1e-6)
  np.testing.assert_allclose(z[6:12], q_r.loc[6:12].detach().numpy(),
                             rtol=1e-6)            # RNA-only rows


# ------------------------------------------------------------- serving
def _stream_keys(rng, k):
  keys = []
  for _ in range(k):
    rng, sub = jax.random.split(rng)
    keys.append(sub)
  return keys


@functools.lru_cache(maxsize=None)
def _serving_apply(name, sample_shape):
  module = _weights(name)[0].module
  return jax.jit(lambda v, x, key, lib: module.apply(
      v, x, rngs={"sample": key}, training=False, sample_shape=sample_shape,
      library=lib))


def _jax_draws(name, jm, data, sample_shape=(), batch=B):
  """The eps of JAX's streaming serving calls on ``data``, batch by batch,
  recovered as (z − loc)/scale for the model's latents."""
  n = len(data[0])
  variables = {"params": jm.params, "batch_stats": jm.batch_stats}
  lib = _library(data[0])
  apply = functools.partial(_serving_apply(name, sample_shape), variables)
  draws = []
  for i, key in enumerate(_stream_keys(jm._rng, -(-n // batch))):
    rows = slice(i * batch, (i + 1) * batch)
    out = apply(jm._module_input([jnp.asarray(a[rows]) for a in data]), key,
                jnp.asarray(lib[rows]))
    k = jm.n_latents
    draws.append([torch.tensor(np.asarray((z - q.mean()) / jnp.sqrt(
        q.variance()))) for q, z in zip(out.latents[:k],
                                        out.latent_samples[:k])])
  return draws


@contextlib.contextmanager
def _fed(tm, draws):
  it = iter(draws)
  sample = type(tm.module)._sample
  tm.module._sample = lambda qZ, ss, gen, noise: sample(
      tm.module, qZ, ss, gen, next(it))
  try:
    yield
    assert next(it, None) is None, "fewer draws taken than made"
  finally:
    del tm.module._sample


@pytest.mark.parametrize("device_cache", [False, True])
def test_serving_keeps_two_latents_and_the_theta_row(device_cache):
  """``encode`` and ``predict`` return (z, library), not the experts (the
  forward keeps all four); ``predict`` keeps MULTIVI's per-gene θ one
  (1, genes) row over several batches."""
  _, tm = _pair("multivi_b")
  data = _data("multivi_b", seed=4, n=70)
  pX, qZ = tm.predict(data, batch_size=B, device_cache=device_cache)
  assert len(qZ) == 2 and len(pX) == 2
  assert tuple(pX[0].base.disp.shape) == (1, G)
  assert tuple(pX[0].mean().shape) == (70, G)
  assert tuple(pX[1].mean().shape) == (70, R)
  xin = tm._module_input([torch.tensor(a) for a in data])
  assert len(tm.encode(xin, library=_library(data[0]))) == 2
  assert len(tm.apply(xin, library=_library(data[0])).latents) == 4


@pytest.mark.parametrize("region", [True, False])
@pytest.mark.parametrize("name", ["peakvi", "multivi_b"])
def test_accessibility_estimates_match_jax(name, region):
  """Depth-free σ(ℓ_y)·σ(ρ) (or σ(ℓ_y)) at the posterior means, in [0, 1]
  and equal to JAX's (70 cells: a ragged last batch); dropping the region
  factor never lowers an estimate."""
  jm, tm = _pair(name)
  data = _data(name, seed=6, n=70)
  j = np.asarray(jm.get_accessibility_estimates(data, batch_size=B,
                                                region=region))
  t = tm.get_accessibility_estimates(data, batch_size=B, region=region)
  assert t.shape == (70, R) and ((t >= 0) & (t <= 1)).all()
  np.testing.assert_allclose(t, j, **CLOSE)
  if region:
    free = tm.get_accessibility_estimates(data, batch_size=B, region=False)
    assert (free >= t).all()


def test_marginal_log_prob_matches_jax_with_the_expert_terms():
  """JAX's ``marginal_log_prob`` sums q.log_prob over every latent of the
  forward, MULTIVI's two experts at their own means included, with no
  prior to offset them. The port keeps that value: it equals JAX's at the
  same draws, and it is the (z, l) estimate less log q_r(μ_r) + log
  q_a(μ_a) per cell."""
  jm, tm = _pair("multivi_b")
  data = _data("multivi_b", seed=7, n=40)
  draws = _jax_draws("multivi_b", jm, data, (5,))
  j = np.asarray(jm.marginal_log_prob(data, sample_shape=5, batch_size=B))
  with _fed(tm, draws):
    t = tm.marginal_log_prob(data, sample_shape=5, batch_size=B)
  assert t.shape == (40,)
  np.testing.assert_allclose(t, j, **CLOSE)
  parts = []
  lib = _library(data[0])
  with torch.no_grad(), _fed(tm, draws):
    for s in range(0, 40, B):
      xs = [torch.tensor(a[s:s + B]) for a in data]
      out = tm._serve(tm._module_input(xs), torch.tensor(lib[s:s + B]), (5,))
      lw = out.outputs[0].log_prob(xs[0])
      for q, p, z in zip(out.latents[:2], out.priors[:2],
                         out.latent_samples[:2]):
        lw = lw + p.log_prob(z) - q.log_prob(z)
      shift = -sum(q.log_prob(q.mean()) for q in out.latents[2:])
      parts.append((torch.logsumexp(lw, 0) - np.log(5.0) + shift).numpy())
  np.testing.assert_allclose(t, np.concatenate(parts), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------- checkpoints
def _perturbed_port(name):
  tm = _build(name, TRV, T, device="cpu", seed=3, dataset="toy_multiome")
  gen = torch.Generator().manual_seed(4)
  with torch.no_grad():
    for key, v in tm.module.state_dict().items():
      if key.endswith("running_var"):
        v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
      else:
        v.add_(0.2 * torch.randn(v.shape, generator=gen))
  return tm


def _assert_same_leaves(jm, tm):
  params, stats = convert.torch_to_jax(tm.module)
  for jt, tt in ((jm.params, params), (jm.batch_stats, stats)):
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jt))
    tl = jax.tree_util.tree_leaves_with_path(tt)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
      np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", ["peakvi", "multivi_b"])
def test_checkpoints_move_both_ways(name, tmp_path, monkeypatch):
  """JAX ``save_weights`` → port ``load_model`` → port save: byte-identical
  msgpack and the same metamodel.json; port save → JAX ``load_model`` →
  JAX save: the same bytes. The metamodel carries ``depth_conf`` (and
  MULTIVI's ``modality_penalty``). JAX's ``load_model`` takes its template
  from the traced shapes (``_weights``), not from an eager flax init."""
  jm, _ = _pair(name)
  cls = type(jm)
  monkeypatch.setattr(cls, "_ensure_initialized", lambda self: (
      self._state is None and _set_state(self, *_weights(name)[1:])))
  jm.save_weights(str(tmp_path / "jax"))
  tm = T.load_model(str(tmp_path / "jax"), device="cpu")
  assert type(tm).__name__ == type(jm).__name__
  _assert_same_leaves(jm, tm)
  tm.save_weights(str(tmp_path / "port"))
  src = _perturbed_port(name)
  src.save_weights(str(tmp_path / "port2"))
  back = J.load_model(str(tmp_path / "port2"))
  _assert_same_leaves(back, src)
  back.save_weights(str(tmp_path / "jax2"))
  for a, b in (("jax", "port"), ("port2", "jax2")):
    for f in ("params.msgpack", "batch_stats.msgpack"):
      assert (tmp_path / a / f).read_bytes() == (tmp_path / b / f).read_bytes()
  meta = [json.loads((tmp_path / d / "metamodel.json").read_text())
          for d in ("jax", "port", "port2", "jax2")]
  assert meta[0] == meta[1] and meta[2] == meta[3]
  kw = meta[0]["init_kwargs"] if "init_kwargs" in meta[0] else meta[0]
  text = json.dumps(kw)
  assert "depth_conf" in text
  if name.startswith("multivi"):
    assert "modality_penalty" in text and tm.modality_penalty == 2.0
    assert back.modality_penalty == 2.0


# ----------------------------------------------------------- the surface
def test_models_resolve_and_coerce():
  assert T.get_model("peakvi") is T.PEAKVI
  assert T.get_model("MULTIVI") is T.get_model("multivi") is T.MULTIVI
  p = T.PEAKVI(TRV(R, "zinb", name="atac"), device="cpu")
  assert (p.outputs[0].posterior, p.outputs[0].projection, p.log_norm) \
      == ("bernoulli", False, False)
  assert p.module.depth_encoder.conf.units == (32,)
  m = T.MULTIVI([TRV(G, "zinbd", name="rna"), TRV(R, "nb", name="atac")],
                device="cpu")
  assert m.outputs[1].posterior == "bernoulli" and m.uses_library
  assert [(rv.dim, rv.posterior) for rv in m.latents] == [(16, "diag"),
                                                          (1, "normal")]
  assert [e.units for e in m.encoder] == [(128, 128)] * 2
  assert all(e.batchnorm and e.dropout == 0.1 for e in m.encoder)
  assert [d.units for d in m.decoder] == [(128, 128)] * 2
  assert m.module.depth_encoder.conf.units == (32,)
  assert m.modality_penalty == 1.0 and m.module.latent_heads[0] is None
  b = torch.tensor(_data("multivi", kind="mosaic")[1])
  assert set(np.unique(m._loss_targets({"inputs": [b, b]})[1])) == {0, 1}
  with pytest.raises(ValueError, match="exactly"):
    T.MULTIVI(TRV(G, "zinbd", name="rna"), device="cpu")
  with pytest.raises(ValueError, match="count likelihood"):
    T.MULTIVI([TRV(G, "normal"), TRV(R, "bernoulli")], device="cpu")


@pytest.mark.parametrize("name", ["peakvi", "multivi_b"])
def test_fit_on_cpu(name):
  """``fit(train, valid=…)`` on mosaic data: finite, falling loss,
  MULTIVI's ``modality_penalty`` and ``val_`` keys in the history; no
  kernel launched off the card."""
  data = [np.concatenate(p) for p in zip(*(
      _data(name, seed=s, n=64, kind="mosaic") for s in range(3)))]
  m = _build(name, TRV, T, device="cpu")
  tz.reset_launches()
  m.fit([a[:160] for a in data], valid=[a[160:] for a in data], epochs=4,
        batch_size=32, learning_rate=3e-3, metrics_interval=2,
        device_cache=True)
  h = m.history
  assert len(h["loss"]) == 4 and len(h["val_loss"]) == 2
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert np.isfinite(h["val_loss"]).all()
  if name.startswith("multivi"):
    assert {"modality_penalty", "val_modality_penalty", "klqp_z1",
            "llk_x1"} <= set(h)
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}

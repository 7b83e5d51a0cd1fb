"""The port's SCScope and AUTOZI against the JAX package at converted
weights, and the distributions they need ('nzmse', Gamma, LogNormal).

SCScope: loss, ``llk_cycles``, every parameter gradient and the BatchNorm
running statistics after one training step, at ``t_steps`` 1–3, with the
'nzmse' and 'zinb' heads and at ``n_batch`` > 0; its latent is
deterministic, so no draw is replayed. AUTOZI: ``beta_kl``,
``compose_gate_logits`` at the −1e-7 clamp, and one step in eval mode and
in train mode. Train mode replays JAX's draws: the latents from the first
'sample' key, and δ's two log-gamma draws from the second, through the
threefry key the JAX module seeds from it (``jax.random.loggamma`` of the
split keys). Checkpoints: a JAX SCScope whose imputer is written chunked
(both chunk limits lowered) loads in the port and saves back byte-identical;
AUTOZI's ``n_total_cells`` travels in the kwargs.

Dropout is 0 in these nets; BatchNorm runs on batch stats in training.
Tolerances: loss and metrics rtol 1e-4; gradients rtol 1e-4 with an atol of
1e-4·(largest |gradient| of the model), except δ's two parameters, whose
implicit gamma gradients come from two implementations of the same
approximation (JAX's ``random_gamma_grad``, torch's
``_standard_gamma_grad``): rtol 2e-3; distributions rtol 1e-5 as
tests/test_torch_port_dist.py.
"""

import functools
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.models import autozi as jautozi
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models import autozi as tautozi
from sisua_tpu_torch.nn import BatchNorm
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import msgpack as tmp
from torch_port_threads import _one_thread  # noqa: F401


G, B, NB = 24, 16, 3
CLOSE = dict(rtol=1e-4, atol=1e-5)
NETS = dict(encoder={"units": [16, 16], "batchnorm": True},
            decoder={"units": [16, 16], "batchnorm": True})
DELTA_RTOL = 2e-3
# AUTOZI's nets: SCVI's library encoder has dropout 0.1 by default
AUTOZI_NETS = dict(NETS, encoder_l={"units": [16], "batchnorm": True},
                   latents=dict(dim=4, posterior="diag", name="latents"))

# name → (class, main head, constructor kwargs)
CASES = {
    "scscope_t1": ("SCScope", "nzmse", dict(NETS, latent_dim=4, t_steps=1)),
    "scscope_t2": ("SCScope", "nzmse", dict(NETS, latent_dim=4, t_steps=2)),
    "scscope_t3": ("SCScope", "nzmse", dict(NETS, latent_dim=4, t_steps=3)),
    "scscope_zinb": ("SCScope", "zinb", dict(NETS, latent_dim=4, t_steps=2)),
    "scscope_batch": ("SCScope", "nzmse", dict(NETS, latent_dim=4,
                                               t_steps=2, n_batch=NB)),
    "autozi": ("AUTOZI", "zinbd", dict(AUTOZI_NETS, n_total_cells=500)),
    "autozi_single": ("AUTOZI", "zinbd", dict(AUTOZI_NETS,
                                               dispersion="single",
                                               n_batch=NB)),
}


def _build(name, RV, zoo, **extra):
  cls, head, kw = CASES[name]
  return getattr(zoo, cls)(RV(G, head, name="rna"), **kw, **extra)


def _batch(name, seed=0, n=B):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  x[1] = 0.0  # an all-zero cell: 'nzmse' scores it 0
  inputs = [x]
  if CASES[name][2].get("n_batch"):
    inputs.append(np.eye(NB, dtype=np.float32)[rng.integers(0, NB, n)])
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(n, logc.mean()), np.full(n, logc.var())],
                 1).astype(np.float32)
  return {"inputs": inputs, "library": lib, "mask": np.ones(n, np.float32)}


def _random_state(jm, seed=11):
  """Random params and batch stats in ``jm``'s layout (the flax init is
  traced for its shapes only); δ's parameters spread over ±1, so both
  JAX gamma branches (a < 1 boosted, a ≥ 1) are drawn."""
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
    elif name.endswith("_delta"):
      a = rng.uniform(-1.0, 1.0, s.shape)
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


def _pair(name):
  _, params, stats = _weights(name)
  jm = _set_state(_build(name, JRV, J, seed=5), params, stats)
  tm = _build(name, TRV, T, device="cpu", seed=5)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return jm, tm


def _port_grad_tree(module):
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


def _autozi_noise(jm, variables, x, k_sample, out, training):
  """JAX's draws of one AUTOZI forward: z and l from the first 'sample'
  key; in train mode δ's (log Ga, log Gb) from the second, through the
  threefry key the module seeds from its 32 bits."""
  k1, k2 = jm.module.apply(
      variables, x, rngs={"sample": k_sample},
      method=lambda m, *a, **k: (m.make_rng("sample"), m.make_rng("sample")))
  noise = [torch.tensor(np.asarray(jax.random.normal(
      k, tuple(q.batch_shape) + tuple(q.event_shape))))
      for q, k in zip(out.latents, jax.random.split(k1, len(out.latents)))]
  if training:
    p = variables["params"]
    a = jnp.exp(jnp.clip(p["log_alpha_delta"], -10.0, 10.0))
    b = jnp.exp(jnp.clip(p["log_beta_delta"], -10.0, 10.0))
    seed = jax.random.bits(k2, (), jnp.uint32)
    ka, kb = jax.random.split(jax.random.key(seed, impl="threefry2x32"))
    noise.append((torch.tensor(np.asarray(jax.random.loggamma(ka, a))),
                  torch.tensor(np.asarray(jax.random.loggamma(kb, b)))))
  return noise


@functools.lru_cache(maxsize=None)
def _jax_side(name, training=True):
  jm, params, bs = _weights(name)
  batch = jax.tree_util.tree_map(jnp.asarray, _batch(name))
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  (loss, (metrics, new_bs, out)), grads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=training),
      has_aux=True))(pj)
  noise = None
  if CASES[name][0] == "AUTOZI":
    k1, _ = jax.random.split(key)
    noise = _autozi_noise(jm, {"params": pj, "batch_stats": bs},
                          jm._masked_module_input(batch, training), k1, out,
                          training)
  return dict(loss=float(loss), metrics=jax.device_get(metrics),
              grads=jax.device_get(grads), stats=jax.device_get(new_bs),
              out=out, noise=noise)


def _run_port(name, mode, noise, training=True):
  _, tm = _pair(name)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    batch = jax.tree_util.tree_map(torch.tensor, _batch(name))
    loss, metrics, out = tm._loss(batch, training, 1.0, noise=noise)
    loss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module), model=tm)


def _assert_grads(j, t, loose=()):
  jl = jax.tree_util.tree_leaves_with_path(j["grads"])
  tl = jax.tree_util.tree_leaves_with_path(t["grads"])
  assert [p for p, _ in jl] == [p for p, _ in tl]
  scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jl)
  for (path, jg), (_, tg) in zip(jl, tl):
    key = jax.tree_util.keystr(path)
    rtol = DELTA_RTOL if any(k in key for k in loose) else 1e-4
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=rtol,
                               atol=1e-4 * scale, err_msg=key)


def _assert_metrics(j, t):
  np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
  assert set(t["metrics"]) == set(j["metrics"])
  for k in j["metrics"]:
    np.testing.assert_allclose(float(t["metrics"][k].detach()),
                               float(j["metrics"][k]), rtol=1e-4, atol=1e-6,
                               err_msg=k)


# ------------------------------------------------------------ distributions
@pytest.mark.parametrize("log_space", [True, False])
def test_nonzero_masked_deterministic_matches_jax(log_space):
  """−Σ(t − loc)²·m / max(Σm, 1), m = x > 0, t = log1p(x) in log space;
  an all-zero row scores 0; mean, mode and draws are expm1(loc) in log
  space; its KL to anything is 0."""
  rng = np.random.default_rng(0)
  loc = np.abs(rng.normal(0, 1, (5, 7))).astype(np.float32)
  x = (rng.poisson(3.0, (5, 7)) * (rng.uniform(size=(5, 7)) > 0.4)
       ).astype(np.float32)
  x[2] = 0.0
  td = TD.NonzeroMaskedDeterministic(torch.tensor(loc), log_space=log_space)
  jd = JD.NonzeroMaskedDeterministic(loc=jnp.asarray(loc),
                                     log_space=log_space)
  lp = td.log_prob(torch.tensor(x))
  np.testing.assert_allclose(lp.numpy(), np.asarray(jd.log_prob(x)),
                             rtol=1e-5)
  assert float(lp[2]) == 0.0
  for f in ("mean", "mode"):
    np.testing.assert_allclose(getattr(td, f)().numpy(),
                               np.asarray(getattr(jd, f)()), rtol=1e-5)
  draw = td.rsample((3,))
  assert draw.shape == (3, 5, 7)
  np.testing.assert_allclose(draw[1].numpy(), np.asarray(
      jd.sample(jax.random.key(0), (3,))[1]), rtol=1e-5)
  prior = TD.MultivariateNormalDiag(torch.zeros(7), torch.ones(7))
  assert torch.equal(TD.kl_divergence(td, prior), torch.zeros(5))


def test_gamma_and_lognormal_match_jax():
  """log_prob, mean, variance and mode at the same parameters; draws from
  the generator are reproducible and of the right mean; Gamma's
  ``rsample`` carries the implicit gradient to the concentration."""
  rng = np.random.default_rng(1)
  a = rng.gamma(2.0, 1.0, (6,)).astype(np.float32) + 0.1
  b = rng.gamma(2.0, 1.0, (6,)).astype(np.float32) + 0.1
  x = rng.gamma(2.0, 1.0, (4, 6)).astype(np.float32) + 0.05
  pairs = [(TD.Gamma(torch.tensor(a), torch.tensor(b)),
            JD.Gamma(concentration=jnp.asarray(a), rate=jnp.asarray(b))),
           (TD.LogNormal(torch.tensor(a - 1), torch.tensor(b / 4)),
            JD.LogNormal(loc=jnp.asarray(a - 1), scale=jnp.asarray(b / 4)))]
  for td, jd in pairs:
    np.testing.assert_allclose(td.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    fields = ("mean", "variance", "mode") if isinstance(td, TD.Gamma) \
        else ("mean", "variance")
    for f in fields:
      np.testing.assert_allclose(getattr(td, f)().numpy(),
                                 np.asarray(getattr(jd, f)()), rtol=1e-5)
    draws = [td.sample((20000,), generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (20000, 6)
    np.testing.assert_allclose(draws[0].mean(0).numpy(), td.mean().numpy(),
                               rtol=0.1)
  conc = torch.tensor(a, requires_grad=True)
  TD.Gamma(conc, torch.tensor(b)).rsample(
      generator=torch.Generator().manual_seed(0)).sum().backward()
  assert torch.isfinite(conc.grad).all() and (conc.grad != 0).all()


# ------------------------------------------------------------------ SCScope
SCSCOPE = [n for n in CASES if n.startswith("scscope")]


@pytest.mark.parametrize("name", SCSCOPE)
def test_scscope_step_matches_jax(name):
  """One training step: loss, ``llk_cycles`` (absent at t_steps 1),
  every gradient through the unrolled recurrence, and the BatchNorm
  running stats, updated once per cycle in order as flax's mutable apply;
  the 'zinb' head's last cycle on the fused op too."""
  j = _jax_side(name, True)
  modes = ["off", "on"] if CASES[name][1] == "zinb" else ["off"]
  for mode in modes:
    t = _run_port(name, mode, None)
    _assert_metrics(j, t)
    assert ("llk_cycles" in t["metrics"]) == (CASES[name][2]["t_steps"] > 1)
    _assert_grads(j, t)
    tm = t["model"]
    _, stats = convert.torch_to_jax(tm.module)
    jl = jax.tree_util.tree_leaves_with_path(j["stats"])
    tl = jax.tree_util.tree_leaves_with_path(stats)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
      np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6,
                                 err_msg=jax.tree_util.keystr(path))
  assert len(t["out"].aux_outputs) == len(j["out"].aux_outputs) \
      == CASES[name][2]["t_steps"] - 1
  for ja, ta in zip(j["out"].aux_outputs + j["out"].outputs[:1],
                    t["out"].aux_outputs + t["out"].outputs[:1]):
    np.testing.assert_allclose(ta.mean().detach().numpy(),
                               np.asarray(ja.mean()), rtol=1e-4, atol=1e-4)


def test_scscope_batch_stats_update_once_per_cycle():
  """Three cycles, three updates in order: the encoder's first running
  mean after one step is 0.9³·old + Σ_t 0.1·0.9^(2−t)·(cycle t's batch
  mean); the JAX package's mutable apply gives the same stats
  (``test_scscope_step_matches_jax``)."""
  _, tm = _pair("scscope_t3")
  bn = tm.module.encoder0.bn0
  old = bn.running_mean.clone()
  means = []
  bn.register_forward_pre_hook(
      lambda mod, args: means.append(args[0].detach().mean(0)))
  tm._loss(jax.tree_util.tree_map(torch.tensor, _batch("scscope_t3")), True,
           1.0)
  assert len(means) == 3
  want = old
  for mu in means:
    want = 0.9 * want + 0.1 * mu
  torch.testing.assert_close(bn.running_mean, want, rtol=1e-6, atol=1e-7)
  assert not torch.allclose(bn.running_mean, 0.9 * old + 0.1 * means[-1])


def test_scscope_eval_loss_and_serving_shapes():
  """Eval mode (running stats) matches JAX; ``sample_shape`` only on the
  last cycle; the coercions of heads and latents."""
  j = _jax_side("scscope_t2", False)
  t = _run_port("scscope_t2", "off", None, training=False)
  _assert_metrics(j, t)
  _, tm = _pair("scscope_t2")
  with torch.no_grad():
    out = tm.apply(_batch("scscope_t2")["inputs"][0], sample_shape=(3,))
  assert out.outputs[0].mean().shape == (3, B, G)
  assert out.aux_outputs[0].mean().shape == (B, G)
  m = T.SCScope(TRV(G, "zinbd", name="rna"), latents=TRV(4, "diag"),
                device="cpu")
  assert m.outputs[0].posterior == "zinbd" and m.t_steps == 2
  assert m.latents[0].posterior == "linear"
  assert T.SCScope(TRV(G, "bernoulli"), device="cpu").outputs[0].posterior \
      == "nzmse"


def test_jax_scscope_checkpoint_with_a_chunked_imputer(tmp_path, monkeypatch):
  """Both chunk limits lowered below the imputer's G×G kernel: the JAX
  checkpoint holds it as a chunked map, the port loads it (the same
  leaves), saves it back byte-identical, and JAX reads the port's."""
  monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 512)
  monkeypatch.setattr(tmp, "MAX_LEAF_BYTES", 512)
  jm, _ = _pair("scscope_t2")
  jm.save_weights(str(tmp_path / "jax"))
  raw = (tmp_path / "jax" / "params.msgpack").read_bytes()
  assert b"__msgpack_chunked_array__" in raw
  tm = T.load_model(str(tmp_path / "jax"), device="cpu")
  assert isinstance(tm, T.SCScope) and tm.t_steps == 2
  params, stats = convert.torch_to_jax(tm.module)
  for jt, tt in ((jm.params, params), (jm.batch_stats, stats)):
    jl = jax.tree_util.tree_leaves(jax.device_get(jt))
    tl = jax.tree_util.tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
      np.testing.assert_array_equal(np.asarray(a), b)
  tm.save_weights(str(tmp_path / "port"))
  for f in ("params.msgpack", "batch_stats.msgpack"):
    assert (tmp_path / "port" / f).read_bytes() \
        == (tmp_path / "jax" / f).read_bytes()
  back = J.load_model(str(tmp_path / "port"))
  np.testing.assert_array_equal(
      np.asarray(back.params["Imputation"]["kernel"]),
      np.asarray(jm.params["Imputation"]["kernel"]))


def test_scscope_imputer_diverges_when_lr_times_genes_is_large():
  """Adam's first step moves every weight of an imputer row by ~lr in one
  direction, so an imputed value by ~lr·Σ inputs, and expm1 overflows
  into a non-finite loss. At lr·genes = 33 (lr 1e-3 at 33,000 genes; here
  lr 0.0825 at 400 genes) both packages stop on a non-finite loss within
  four epochs: the JAX value, mirrored."""
  rng = np.random.default_rng(0)
  g = 400
  x = (rng.poisson(np.exp(rng.normal(-2.5, 1.2, (512, g))))
       * (rng.uniform(size=(512, g)) > 0.5)).astype(np.float32)
  fit = dict(epochs=4, batch_size=128, learning_rate=1e-3 * 33_000 / g)
  jm = J.SCScope(JRV(g, "nzmse", name="rna"), latent_dim=50, seed=0)
  tm = T.SCScope(TRV(g, "nzmse", name="rna"), latent_dim=50, seed=0,
                 device="cpu")
  for m in (jm.fit(x, **fit), tm.fit(x, **fit)):
    losses = [float(v) for v in m.history["loss"]]
    assert len(losses) <= 4 and not np.isfinite(losses[-1]), losses


# ------------------------------------------------------------------- AUTOZI
def test_beta_kl_matches_jax():
  """Over the whole clipped range a, b ∈ [e^−10, e^10]. The lgamma and
  digamma terms of size ~(a + b)·log(a + b) cancel, so both packages sit
  up to ~1e-2 from the float64 value at a + b ~ 1e4: the atol is 1e-6 of
  that size, elementwise."""
  rng = np.random.default_rng(2)
  a = np.exp(rng.uniform(-10, 10, 64)).astype(np.float32)
  b = np.exp(rng.uniform(-10, 10, 64)).astype(np.float32)
  a[:4], b[:4] = 1.0, 1.0
  t = tautozi.beta_kl(torch.tensor(a), torch.tensor(b), 0.5, 0.5).numpy()
  j = np.asarray(jautozi.beta_kl(jnp.asarray(a), jnp.asarray(b), 0.5, 0.5))
  size = (a + b) * (1.0 + np.abs(np.log(a + b)))
  assert (np.abs(t - j) <= 1e-4 * np.abs(j) + 1e-6 * size).all()


def test_compose_gate_logits_at_the_clamp():
  """Values and gradients of both inputs, log δ from −5 to −1e-8 against
  gates up to 30: the pairs whose log π' exceeds −1e-7 are clamped (zero
  gradient in both packages)."""
  ld = np.array([-5.0, -0.5, -1e-6, -1e-8], np.float32)[:, None]
  gate = np.array([-30.0, -2.0, 0.0, 3.0, 30.0], np.float32)[None, :]
  ld, gate = np.broadcast_arrays(ld, gate)
  ld, gate = ld.copy(), gate.copy()
  tl = torch.tensor(ld, requires_grad=True)
  tg = torch.tensor(gate, requires_grad=True)
  out = tautozi.compose_gate_logits(tl, tg)
  out.sum().backward()
  j = jautozi.compose_gate_logits(jnp.asarray(ld), jnp.asarray(gate))
  jgl, jgg = jax.grad(lambda a, b: jautozi.compose_gate_logits(a, b).sum(),
                      (0, 1))(jnp.asarray(ld), jnp.asarray(gate))
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), rtol=1e-4,
                             atol=1e-6)
  np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), rtol=1e-4,
                             atol=1e-6)
  clamped = ld + np.log(1 / (1 + np.exp(-gate.astype(np.float64)))) > -1e-7
  assert clamped.any() and (tl.grad.numpy()[clamped] == 0).all()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["autozi", "autozi_single"])
def test_autozi_step_matches_jax(name, training):
  """Loss, ``klqp_delta`` and every gradient (δ's two parameters among
  them, through the implicit gamma gradients in train mode), on both
  likelihood routes: the composed gate keeps the main head on the fused
  op ('loglog' for 'full' dispersion, 'displog' for 'single')."""
  j = _jax_side(name, training)
  for mode in ("off", "on"):
    t = _run_port(name, mode, j["noise"], training)
    _assert_metrics(j, t)
    assert "klqp_delta" in t["metrics"]
    _assert_grads(j, t, loose=("_delta",))
    for path in ("log_alpha_delta", "log_beta_delta"):
      assert np.abs(t["grads"][path]).max() > 0
    np.testing.assert_allclose(t["out"].outputs[0].base.gate_logits.detach()
                               .numpy(), np.asarray(
                                   j["out"].outputs[0].base.gate_logits),
                               rtol=1e-4, atol=1e-5)


def test_autozi_fused_route_launches_on_the_composed_gate(monkeypatch):
  """On the fused route the main head reaches the fused op once (its
  gate the composed (B, D) logits) and its gate gradient reaches δ."""
  from sisua_tpu_torch.ops import zinb as tz
  calls = []
  real = tz.zinb_log_prob_rowsum
  monkeypatch.setattr(tz, "zinb_log_prob_rowsum",
                      lambda *a, **k: calls.append(a[3].shape) or real(*a,
                                                                      **k))
  j = _jax_side("autozi", True)
  t = _run_port("autozi", "on", j["noise"])
  assert calls == [(B, G)]
  assert np.abs(t["grads"]["log_alpha_delta"]).max() > 0


def test_autozi_accessors_coercions_and_draws():
  _, tm = _pair("autozi")
  jm, _ = _pair("autozi")
  ab, jab = tm.get_alphas_betas(), jm.get_alphas_betas()
  for k in ("alpha_posterior", "beta_posterior"):
    np.testing.assert_allclose(ab[k], jab[k], rtol=1e-6)
  q = tm.get_zi_probabilities()
  assert isinstance(q, np.ndarray) and q.shape == (G,)
  assert ((q > 0) & (q < 1)).all()
  np.testing.assert_allclose(q, np.asarray(jm.get_zi_probabilities(
      var_names=None)), rtol=1e-6)
  m = T.AUTOZI(TRV(G, "nbd", name="rna"), device="cpu")
  assert m.outputs[0].posterior == "zinbd" and m.module.inflation == "full"
  # δ drawn from the generator: in (0, 1), reproducible, one per step
  tm.module.train()
  draws = []
  for _ in range(2):
    tm.generator.manual_seed(4)
    draws.append(tm.module.sample_delta(tm.generator))
  assert torch.equal(draws[0], draws[1]) and draws[0].shape == (G,)
  assert ((draws[0] >= 1e-6) & (draws[0] <= 1 - 1e-6)).all()


def test_autozi_n_total_cells_is_stale_on_refit(monkeypatch):
  """``fit`` sets ``n_total_cells`` from the first training set and keeps
  it on a refit with more cells: the JAX value (ADVICE finding, mirrored).
  The training itself is skipped in both packages."""
  monkeypatch.setattr(J.SCVI, "fit", lambda self, *a, **k: self)
  monkeypatch.setattr(T.SCVI, "fit", lambda self, *a, **k: self)
  jm, tm = _pair("autozi_single")
  x = _batch("autozi_single")["inputs"]
  seen = []
  for m in (jm, tm):
    m._n_total_cells = None
    m.fit([np.zeros((40, G), np.float32), x[1][:1].repeat(40, 0)],
          device_cache=True)
    m.fit([np.zeros((60, G), np.float32), x[1][:1].repeat(60, 0)],
          device_cache=True)
    seen.append((m._n_total_cells, m._init_kwargs_for_save["n_total_cells"]))
  assert seen[0] == seen[1] == (40, 40)


def test_autozi_checkpoint_keeps_n_total_cells(tmp_path):
  """JAX → port → JAX: δ's parameters and ``n_total_cells`` come back,
  and the files are byte-identical."""
  jm, _ = _pair("autozi")
  jm.save_weights(str(tmp_path / "jax"))
  tm = T.load_model(str(tmp_path / "jax"), device="cpu")
  assert isinstance(tm, T.AUTOZI) and tm.n_total_cells == 500
  np.testing.assert_array_equal(
      tm.module.log_alpha_delta.detach().numpy(),
      np.asarray(jm.params["log_alpha_delta"]))
  tm.save_weights(str(tmp_path / "port"))
  for f in ("params.msgpack", "batch_stats.msgpack"):
    assert (tmp_path / "port" / f).read_bytes() \
        == (tmp_path / "jax" / f).read_bytes()
  assert J.load_model(str(tmp_path / "port"))._n_total_cells == 500

"""The port's SCVI slice against the JAX package at converted weights:
converter, forward, loss and parameter gradients, BatchNorm running stats,
the clipped-Adam update, and a CPU ``fit``/``evaluate``.

Both sides get the same numpy inputs and the same reparameterization
noise: the JAX forward's noise is recovered as eps = (z − loc)/scale and
handed to the port (JAX rbg keys and torch generators never draw alike).
Dropout is 0 where outputs are compared; BatchNorm runs on batch stats.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sisua_tpu.models import SCVI as JSCVI
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch.models import SCVI as TSCVI
from sisua_tpu_torch.nn import BatchNorm
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import ClippedAdam
from torch_port_threads import _one_thread  # noqa: F401


G, B = 60, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(dispersion):
  return dict(latents=dict(dim=8, posterior="diag", name="latents"),
              encoder={"units": [32, 32], "batchnorm": True},
              encoder_l={"units": [16], "batchnorm": True},
              decoder={"units": [32, 32], "batchnorm": True},
              dispersion=dispersion)


def _data(seed=0, n=B):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(n, logc.mean()), np.full(n, logc.var())],
                 1).astype(np.float32)
  return x, lib


@functools.lru_cache(maxsize=None)
def _jax_model(dispersion):
  jm = JSCVI(JRV(G, "zinbd", name="rna"), **_config(dispersion))
  jm._ensure_initialized()
  params = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.params))
  if dispersion == "single":  # off its zero init, so its gradient shows
    params["px_r_single"] = np.random.default_rng(1).normal(
        0, 0.5, G).astype(np.float32)
  bs = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.batch_stats))
  return jm, params, bs


def _port_model(dispersion, params, bs):
  tm = TSCVI(TRV(G, "zinbd", name="rna"), device="cpu",
             **_config(dispersion))
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, bs))
  return tm


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
def _run_pair(dispersion, mode):
  """One train-mode loss + gradients on both sides at converted weights."""
  jm, params, bs = _jax_model(dispersion)
  x, lib = _data()
  batch = {"inputs": [jnp.asarray(x)], "library": jnp.asarray(lib),
           "mask": jnp.ones((B,))}
  key = jax.random.key(3, impl="rbg")
  (jloss, (jmet, jbs, jout)), jgrads = jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=True),
      has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
  noise = []
  for q, z in zip(jout.latents, jout.latent_samples):
    q = getattr(q, "base", q)
    scale = getattr(q, "scale_diag", getattr(q, "scale", None))
    noise.append(torch.tensor(np.asarray((z - q.loc) / scale)))
  tm = _port_model(dispersion, params, bs)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    tloss, tmet, tout = tm._loss(
        {"inputs": [torch.tensor(x)], "library": torch.tensor(lib),
         "mask": torch.ones(B)}, True, 1.0, noise=noise)
    tloss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  jax_side = dict(loss=float(jloss), metrics=jax.device_get(jmet),
                  batch_stats=jax.device_get(jbs), out=jout,
                  grads=jax.device_get(jgrads))
  port_side = dict(loss=float(tloss.detach()), metrics=tmet, out=tout,
                   grads=_port_grad_tree(tm.module),
                   batch_stats=convert.torch_to_jax(tm.module)[1])
  return jax_side, port_side


DISPERSIONS = ["full", "single"]


@pytest.mark.parametrize("dispersion", DISPERSIONS)
def test_converter_round_trip_consumes_every_leaf(dispersion):
  jm, params, bs = _jax_model(dispersion)
  tm = _port_model(dispersion, params, bs)
  p2, b2 = convert.torch_to_jax(tm.module)
  for a, b in ((params, p2), (bs, b2)):
    assert (jax.tree_util.tree_structure(a)
            == jax.tree_util.tree_structure(b))
    for u, v in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
      np.testing.assert_array_equal(u, v)
  # SCVI's JAX tree, and no head parameters for the main output
  assert {"encoder0", "encoder1", "decoder0", "latent_head_latents",
          "latent_head_library", "MeanScale", "DropoutLogits"} <= set(params)
  assert not any(k.startswith("output_head") for k in params)
  extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
  with pytest.raises(KeyError, match="no torch counterpart"):
    convert.jax_to_torch(tm.module, extra, bs)
  missing = {k: v for k, v in params.items() if k != "MeanScale"}
  with pytest.raises(KeyError, match="no JAX leaf"):
    convert.jax_to_torch(tm.module, missing, bs)
  bad = dict(params, MeanScale=dict(params["MeanScale"],
                                    bias=np.zeros(G + 1, np.float32)))
  with pytest.raises(ValueError, match="shape"):
    convert.jax_to_torch(tm.module, bad, bs)


@pytest.mark.parametrize("dispersion", DISPERSIONS)
def test_forward_matches_jax(dispersion):
  """Posteriors, samples and decoded likelihood parameters, train mode."""
  j, t = _run_pair(dispersion, "off")
  close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                            atol=1e-5)
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    jq, tq = getattr(jq, "base", jq), getattr(tq, "base", tq)
    close(tq.loc.detach().numpy(), np.asarray(jq.loc))
  for jz_, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz_))
  jzi, tzi = j["out"].outputs[0].base, t["out"].outputs[0].base
  close(tzi.gate_logits.detach().numpy(), np.asarray(jzi.gate_logits))
  jc, tc = jzi.count_distribution, tzi.count_distribution
  assert type(tc).__name__ == type(jc).__name__
  close(tc.log_loc.detach().numpy(), np.asarray(jc.log_loc))
  if dispersion == "full":
    close(tc.log_disp.detach().numpy(), np.asarray(jc.log_disp))
  else:
    assert tuple(tc.disp.shape) == (1, G)  # per-gene row, never (B, D)
    close(tc.disp.detach().numpy(), np.asarray(jc.disp))
  pj, pt = j["out"].priors[1].base, t["out"].priors[1].base
  close(pt.scale.numpy(), np.asarray(pj.scale))


@pytest.mark.parametrize("mode", ["off", "on"],
                         ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("dispersion", DISPERSIONS)
def test_loss_and_gradients_match_jax(dispersion, mode):
  """Loss rtol 1e-4; every parameter gradient rtol 1e-4 with an atol of
  1e-4·(largest |gradient| of the model): the Dense biases feeding a
  BatchNorm have a true gradient of 0, where both sides carry ~1e-7
  rounding noise. 'fused_op' routes the likelihood through the fused op's
  CPU path (analytic backward), 'dist_math' through autograd."""
  j, t = _run_pair(dispersion, mode)
  np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
  for k in ("llk_x", "klqp_z", "klqp_z1", "elbo"):
    np.testing.assert_allclose(float(t["metrics"][k].detach()),
                               float(j["metrics"][k]), rtol=1e-4, err_msg=k)
  jl = jax.tree_util.tree_leaves_with_path(j["grads"])
  tl = jax.tree_util.tree_leaves_with_path(t["grads"])
  assert [p for p, _ in jl] == [p for p, _ in tl]
  scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jl)
  for (path, jg), (_, tg) in zip(jl, tl):
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale,
                               err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dispersion", DISPERSIONS)
def test_batchnorm_running_stats_after_one_step(dispersion):
  """flax momentum 0.9 with the biased batch variance (not BatchNorm1d's
  unbiased update): the running stats after the step agree to rtol 1e-5."""
  j, t = _run_pair(dispersion, "off")
  jl = jax.tree_util.tree_leaves_with_path(j["batch_stats"])
  tl = jax.tree_util.tree_leaves_with_path(t["batch_stats"])
  assert len(jl) == len(tl) == 2 * 5  # 5 BatchNorms × (mean, var)
  for (path, a), (_, b) in zip(jl, tl):
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6,
                               err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("clipnorm,grad_scale", [(100.0, 1.0), (0.5, 30.0)],
                         ids=["unclipped", "clipped"])
def test_clipped_adam_matches_optax(clipnorm, grad_scale):
  """Identical gradients through ClippedAdam and optax.chain(
  clip_by_global_norm, adam): parameters agree to rtol 1e-6 for 4 steps,
  with an atol of 1e-6·max|param| for entries that cancel towards 0 (the
  two evaluate the same update in a different order, a few f32 ulps)."""
  rng = np.random.default_rng(7)
  shapes = [(6, 4), (4,), (3,)]
  init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
  grads = [[(grad_scale * rng.normal(0, 1, s)).astype(np.float32)
            for s in shapes] for _ in range(4)]
  params = [torch.tensor(a, requires_grad=True) for a in init]
  opt = ClippedAdam(params, 1e-2, clipnorm)
  tx = optax.chain(optax.clip_by_global_norm(clipnorm), optax.adam(1e-2))
  jp = [jnp.asarray(a) for a in init]
  state = tx.init(jp)
  for g in grads:
    for p, a in zip(params, g):
      p.grad = torch.tensor(a)
    opt.step()
    upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
    jp = optax.apply_updates(jp, upd)
  for p, a in zip(params, jp):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6 * float(np.abs(a).max()))


def _small_model(**kw):
  return TSCVI(TRV(G, "zinbd", name="rna"), device="cpu",
               latents=dict(dim=4, posterior="diag", name="latents"),
               encoder={"units": [32], "batchnorm": True, "dropout": 0.1},
               decoder={"units": [32], "batchnorm": True}, **kw)


def test_fit_on_cpu_loss_falls_and_history():
  """A few steps on CPU: falling loss, per-epoch history with
  cells_per_sec, evaluate finite, and no kernel launches off the card."""
  x, _ = _data(seed=2, n=256)
  m = _small_model()
  tz.reset_launches()
  m.fit(x, epochs=6, batch_size=32, learning_rate=3e-3, metrics_interval=2,
        device_cache=True)
  h = m.history
  assert len(h["loss"]) == 6 and m.step == 6 * 8
  assert {"loss", "elbo", "llk_x", "klqp_z", "klqp_z1", "beta",
          "epoch_time", "cells_per_sec"} <= set(h)
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert all(c > 0 for c in h["cells_per_sec"])
  ev = m.evaluate(x[:100], batch_size=32)  # ragged last batch
  assert np.isfinite(list(ev.values())).all() and "llk_x" in ev
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  # a second fit continues the step count and the history
  m.fit(torch.tensor(x), epochs=1, batch_size=32, device_cache=True)
  assert len(m.history["loss"]) == 7 and m.step == 7 * 8


def test_fit_nan_stops_and_rolls_back():
  """A NaN epoch stops the run and restores the last finite best state."""
  x, _ = _data(seed=3, n=128)
  m = _small_model()
  real = m._train_step

  def poisoned(batch):
    if m.step == 3 * 4:  # first step of the 4th epoch
      with torch.no_grad():
        m.module.MeanScale.weight.fill_(float("nan"))
    return real(batch)

  m._train_step = poisoned
  m.fit(x, epochs=8, batch_size=32, device_cache=True)
  assert len(m.history["loss"]) == 4 and not np.isfinite(
      m.history["loss"][-1])
  assert all(torch.isfinite(p).all() for p in m.module.parameters())
  assert m.step == 3 * 4


def test_fit_max_iter_stops_at_window_boundary():
  x, _ = _data(seed=4, n=128)
  m = _small_model()
  m.fit(x, epochs=10, batch_size=32, max_iter=5, metrics_interval=2,
        device_cache=True)
  assert m.step == 8 and len(m.history["loss"]) == 2


def test_default_device_is_cuda():
  """No silent CPU fallback: device='cuda' raises without a card."""
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  with pytest.raises(RuntimeError, match="cuda"):
    TSCVI(TRV(G, "zinbd"))


def test_port_imports_no_jax():
  code = ("import sisua_tpu_torch, sisua_tpu_torch.models, "
          "sisua_tpu_torch.models.vae, sisua_tpu_torch.models.dca, "
          "sisua_tpu_torch.dist.discrete, sisua_tpu_torch.dist.mixture, "
          "sisua_tpu_torch.train, sisua_tpu_torch.convert, sys; "
          "bad = [m for m in ('jax', 'flax', 'optax', 'pandas', 'sisua_tpu')"
          " if m in sys.modules]; assert not bad, bad")
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("analytic", [True, False], ids=["kl", "mc_kl"])
@pytest.mark.parametrize("mask_outputs,mask_renorm",
                         [(False, False), (True, False), (True, True)])
def test_elbo_terms_masks_and_kl_match_jax(mask_outputs, mask_renorm,
                                           analytic):
  """compute_loss with a second (label) output under the semi-supervised
  mask, α-weighting and renormalization, analytic or Monte-Carlo KL."""
  import sisua_tpu.dist as JD
  import sisua_tpu_torch.dist as TD
  from sisua_tpu.models.module import VAEOutput as JOut
  from sisua_tpu.models.objective import compute_loss as j_loss
  from sisua_tpu_torch.models import VAEOutput as TOut
  from sisua_tpu_torch.models import compute_loss as t_loss
  rng = np.random.default_rng(9)
  arrs = [rng.normal(0, 1, (16, k)).astype(np.float32)
          for k in (5, 5, 3, 3, 5, 3, 4, 4, 4)]
  for i in (1, 3, 7):
    arrs[i] = np.abs(arrs[i]) + 0.3  # scales
  mask = (rng.uniform(size=16) < 0.4).astype(np.float32)

  def build(M, Out, t):
    outs = (M.Independent(M.Normal(t(arrs[0]), t(arrs[1])), 1),
            M.Independent(M.Normal(t(arrs[2]), t(arrs[3])), 1))
    q = M.MultivariateNormalDiag(t(arrs[6]), t(arrs[7]))
    prior = M.MultivariateNormalDiag(t(np.zeros(4, np.float32)),
                                     t(np.ones(4, np.float32)))
    return Out(outputs=outs, latents=(q,), latent_samples=(t(arrs[8]),),
               priors=(prior,)), [t(arrs[4]), t(arrs[5])]

  kw = dict(beta=0.7, alpha=2.5, analytic=analytic,
            mask_outputs=mask_outputs, mask_renorm=mask_renorm)
  tout, ttg = build(TD, TOut, torch.tensor)
  jout, jtg = build(JD, JOut, jnp.asarray)
  tl, tm = t_loss(tout, ttg, mask=torch.tensor(mask), **kw)
  jl, jm = j_loss(jout, jtg, mask=jnp.asarray(mask), **kw)
  np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
  assert set(tm) == set(jm)
  for k in jm:
    np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                               atol=1e-6, err_msg=k)

"""The port's VAE, SISUA, MISA and DeepCountAutoencoder against the JAX
package at converted weights (converter, forward, loss and parameter
gradients under a mixed semi-supervised mask), and the trainer's
validation, early stopping and rollback.

Both sides get the same numpy inputs and mask and the same
reparameterization noise: the JAX forward's noise is recovered as
eps = (z − loc)/scale and handed to the port; DCA's deterministic latent
takes none. Dropout is 0 where outputs are compared; BatchNorm runs on
batch stats.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import BatchNorm
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, B = 60, 6, 32
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})

# name → (model class name, [(dim, posterior, rv name)])
CASES = {
    "vae": ("VAE", [(G, "zinb", "rna")]),
    "sisua_nb": ("SISUA", [(G, "zinb", "rna"), (P, "nb", "adt")]),
    "sisua_onehot": ("SISUA", [(G, "zinb", "rna"), (P, "onehot", "adt")]),
    "misa": ("MISA", [(G, "zinb", "rna"), (P, "nbd", "adt")]),
    "dca": ("DeepCountAutoencoder", [(G, "zinb", "rna")]),
    "dca_mse": ("DeepCountAutoencoder", [(G, "mse", "rna")]),
}


def _kwargs(name, mask_renorm):
  kw = dict(NETS, alpha=10.0, mask_renorm=mask_renorm)
  if CASES[name][0] != "DeepCountAutoencoder":
    kw["latents"] = dict(dim=8, posterior="diag", name="latents")
  return kw


def _models(name, mask_renorm, RV, zoo, **extra):
  cls, outs = CASES[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0],
                           **_kwargs(name, mask_renorm), **extra)


def _data(name, seed=0, n=B):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  if CASES[name][1][-1][1] == "onehot":
    y = np.eye(P, dtype=np.float32)[rng.integers(0, P, n)]
  else:
    y = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P)))).astype(
        np.float32)
  mask = (rng.uniform(size=n) < 0.4).astype(np.float32)
  mask[:2] = [0.0, 1.0]  # mixed, whatever the draw
  return [x, y][:len(CASES[name][1])], mask


@functools.lru_cache(maxsize=None)
def _jax_model(name, mask_renorm):
  jm = _models(name, mask_renorm, JRV, J)
  jm._ensure_initialized()
  params = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.params))
  bs = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.batch_stats))
  return jm, params, bs


def _port_model(name, mask_renorm, params, bs):
  tm = _models(name, mask_renorm, TRV, T, device="cpu")
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
def _jax_side(name, mask_renorm):
  jm, params, bs = _jax_model(name, mask_renorm)
  xs, mask = _data(name)
  batch = {"inputs": [jnp.asarray(a) for a in xs], "mask": jnp.asarray(mask)}
  key = jax.random.key(3, impl="rbg")
  (loss, (metrics, _, out)), grads = jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=True),
      has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
  noise = []
  for q, z in zip(out.latents, out.latent_samples):
    scale = getattr(q, "scale_diag", None)
    noise.append(None if scale is None
                 else torch.tensor(np.asarray((z - q.loc) / scale)))
  return dict(loss=float(loss), metrics=jax.device_get(metrics), out=out,
              grads=jax.device_get(grads), noise=noise)


def _run_port(name, mask_renorm, mode, noise, mask=None):
  _, params, bs = _jax_model(name, mask_renorm)
  xs, data_mask = _data(name)
  tm = _port_model(name, mask_renorm, params, bs)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    loss, metrics, out = tm._loss(
        {"inputs": [torch.tensor(a) for a in xs],
         "mask": torch.tensor(data_mask if mask is None else mask)},
        True, 1.0, noise=noise)
    loss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module))


@pytest.mark.parametrize("name", list(CASES))
def test_converter_round_trip_consumes_every_leaf(name):
  _, params, bs = _jax_model(name, False)
  tm = _port_model(name, False, params, bs)
  p2, b2 = convert.torch_to_jax(tm.module)
  for a, b in ((params, p2), (bs, b2)):
    assert (jax.tree_util.tree_structure(a)
            == jax.tree_util.tree_structure(b))
    for u, v in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
      np.testing.assert_array_equal(u, v)
  heads = {f"output_head_{n}" for _, _, n in CASES[name][1]}
  assert heads | {"latent_head_latents", "encoder0", "decoder0"} \
      == set(params)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
  """Output means and latent means, train mode, same noise."""
  j = _jax_side(name, False)
  t = _run_port(name, False, "off", j["noise"])
  close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                            atol=1e-5)
  for jp, tp in zip(j["out"].outputs, t["out"].outputs):
    assert type(tp).__name__ == type(jp).__name__
    close(tp.mean().detach().numpy(), np.asarray(jp.mean()))
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    close(tq.mean().detach().numpy(), np.asarray(jq.mean()))
  for jz, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz))


@pytest.mark.parametrize("mode", ["off", "on"],
                         ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("mask_renorm", [False, True],
                         ids=["batch_mean", "renorm"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name, mask_renorm, mode):
  """α = 10 and a mixed mask. Loss rtol 1e-4; every parameter gradient
  rtol 1e-4 with an atol of 1e-4·(largest |gradient| of the model): the
  Dense biases feeding a BatchNorm have a true gradient of 0, where both
  sides carry rounding noise. 'fused_op' routes 'zinb'/'nb' through the
  fused op's CPU path (analytic backward), 'dist_math' through autograd."""
  j = _jax_side(name, mask_renorm)
  t = _run_port(name, mask_renorm, mode, j["noise"])
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


@pytest.mark.parametrize("name", ["sisua_nb", "misa"])
def test_mask_gates_the_label_heads(name):
  """The mixed mask changes the loss against an all-ones mask (the JAX
  package's own check), and 'zinb'/'nb' reach the fused op ('logits'
  kind) while MISA's 'mixnb' label head falls through to the
  distribution math: counted by the plain version's autograd Function."""
  j = _jax_side(name, False)
  calls = []
  real = tz._ZinbRowsum.forward

  def counted(ctx, *args):
    calls.append(args[0].shape)
    return real(ctx, *args)

  tz._ZinbRowsum.forward = staticmethod(counted)
  try:
    mixed = _run_port(name, False, "on", j["noise"])["loss"]
  finally:
    tz._ZinbRowsum.forward = staticmethod(real)
  ones = _run_port(name, False, "on", j["noise"],
                   mask=np.ones(B, np.float32))["loss"]
  assert abs(mixed - ones) > 1e-3 * abs(ones)
  expect = [(B, G), (B, P)] if name == "sisua_nb" else [(B, G)]
  assert [tuple(s) for s in calls] == expect


@pytest.mark.parametrize("n_components,zero_inflated", [(2, False),
                                                        (3, True)])
def test_misa_coerced_specs_match_jax(n_components, zero_inflated):
  outs = [(G, "zinb", "rna"), (P, "nbd", "adt"), (4, "diag", "pos"),
          (5, "onehot", "cell"), (3, "mse", "other")]
  kw = dict(NETS, n_components=n_components, zero_inflated=zero_inflated)
  jm = J.MISA([JRV(d, p, name=n) for d, p, n in outs], **kw)
  tm = T.MISA([TRV(d, p, name=n) for d, p, n in outs], device="cpu", **kw)
  as_tuple = lambda rv: (rv.dim, rv.posterior, rv.projection, rv.name,
                         rv.kwargs, rv.n_params)
  assert [as_tuple(r) for r in tm.outputs] == [as_tuple(r)
                                               for r in jm.outputs]
  assert [r.posterior for r in tm.outputs] == ["zinb", "mixnb", "mixgaus",
                                               "onehot", "mdn"]


def test_sisua_rejects_a_single_output():
  with pytest.raises(ValueError, match="≥2 outputs"):
    T.SISUA(TRV(G, "zinb", name="rna"), device="cpu")
  assert T.get_model("sisua") is T.SISUA
  assert T.get_model("dca") is T.DeepCountAutoencoder
  assert T.get_model("scscope") is T.SCScope
  with pytest.raises(ValueError, match="ported"):
    T.get_model("nosuchmodel")


@pytest.mark.parametrize("reduce_latent", ["sum", "mean"])
def test_reduce_latent_sum_and_mean_match_jax(reduce_latent):
  """Two latents reduced before the decoder, as the JAX module does."""
  lat = [dict(dim=4, posterior="diag", name="a"),
         dict(dim=4, posterior="diag", name="b")]
  kw = dict(NETS, latents=lat, reduce_latent=reduce_latent)
  jm = J.VAE(JRV(G, "zinb", name="rna"), **kw)
  jm._ensure_initialized()
  params = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.params))
  bs = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.batch_stats))
  tm = T.VAE(TRV(G, "zinb", name="rna"), device="cpu", **kw)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, bs))
  x = _data("vae")[0][0]
  jout = jm.apply(jnp.asarray(x), training=False)
  noise = [torch.tensor(np.asarray((z - q.loc) / q.scale_diag))
           for q, z in zip(jout.latents, jout.latent_samples)]
  tm.module.eval()
  tout = tm.module(torch.tensor(x), noise=noise)
  np.testing.assert_allclose(tout.outputs[0].mean().detach().numpy(),
                             np.asarray(jout.outputs[0].mean()), rtol=1e-4,
                             atol=1e-5)


def test_sisua_fit_with_valid_on_cpu():
  """A CPU fit with a held-out set: the loss falls, ``llk_x1`` and the
  ``val_*`` keys are in the history (one per window), evaluate is finite,
  and nothing launches a kernel off the card."""
  (x, y), _ = _data("sisua_nb", seed=2, n=320)
  m = T.SISUA([TRV(G, "zinb", name="rna"), TRV(P, "nb", name="adt")],
              device="cpu", alpha=10.0,
              latents=dict(dim=4, posterior="diag", name="latents"),
              encoder={"units": [32], "batchnorm": True,
                       "input_dropout": 0.3},
              decoder={"units": [32], "batchnorm": True})
  tz.reset_launches()
  m.fit([x[:256], y[:256]], valid=[x[256:], torch.tensor(y[256:])],
        epochs=6, batch_size=32, learning_rate=3e-3, labels_percent=0.1,
        metrics_interval=2, device_cache=True)
  h = m.history
  assert len(h["loss"]) == 6 and m.step == 6 * 8
  assert {"llk_x", "llk_x1", "klqp_z", "val_loss", "val_llk_x1"} <= set(h)
  assert len(h["val_loss"]) == 3 and np.isfinite(h["val_loss"]).all()
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  ev = m.evaluate([x[256:], y[256:]], batch_size=24)  # ragged last batch
  assert np.isfinite(list(ev.values())).all() and "llk_x1" in ev
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  with pytest.raises(ValueError, match="one per output"):
    m.fit(x, epochs=1, device_cache=True)
  with pytest.raises(ValueError, match="rows"):
    m.evaluate([x, y[:10]])


@pytest.mark.parametrize("name", ["vae", "misa", "dca", "dca_mse"])
def test_models_fit_with_valid_on_cpu(name):
  """Each model trains through ``fit(train, valid=…)``: finite, falling
  loss and the validation keys, on small nets."""
  xs, _ = _data(name, seed=3, n=192)
  m = _models(name, False, TRV, T, device="cpu")
  m.fit([a[:160] for a in xs], valid=[a[160:] for a in xs], epochs=4,
        batch_size=32, learning_rate=3e-3, metrics_interval=2,
        device_cache=True)
  h = m.history
  assert len(h["loss"]) == 4 and len(h["val_loss"]) == 2
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert np.isfinite(h["val_loss"]).all()


# ------------------------------------------------------------- trainer rule
N_ROWS, STEPS = 64, 2  # batch 32


def _scripted_fit(train, valid=None, **fit_kw):
  """A real fit whose per-epoch train loss and per-window validation loss
  follow scripts. Each step writes the step count into the first
  parameter, so the state a rollback restores names the step it was
  taken at."""
  m = T.VAE(TRV(4, "zinb", name="rna"), device="cpu",
            latents=dict(dim=2, posterior="diag", name="latents"),
            encoder={"units": [4]}, decoder={"units": [4]})
  first = next(m.module.parameters())

  def step(batch):
    epoch = m.step // STEPS
    m.step += 1
    with torch.no_grad():
      first.fill_(float(m.step))
    return {"loss": torch.tensor(float(train[epoch]))}

  vals = iter(valid or ())
  m._train_step = step
  m._evaluate = lambda *a, **k: {"loss": float(next(vals))}
  x = np.ones((N_ROWS, 4), np.float32)
  m.fit(x, valid=x if valid is not None else None, epochs=len(train),
        batch_size=N_ROWS // STEPS, **fit_kw, device_cache=True)
  return m, float(first.detach().flatten()[0]) / STEPS


# Each row: the scripts, the trainer settings, and what the JAX rule
# (sisua_tpu/train/trainer.py::_fit_device_cached) gives: epochs run and
# the epoch count of the state kept (best, or the last when no rollback).
RULE = {
    # windows of 2; the loss stops improving after epoch 4: two flat
    # windows charge 2 + 2 epochs → stop after epoch 8, best after 4
    "plateau_windows": dict(train=[10, 9, 8, 8, 8, 8, 8, 8, 8, 8],
                            kw=dict(metrics_interval=2, patience=4),
                            ran=8, kept=4),
    # the same, without rollback: the state of the last epoch run stays
    "plateau_no_rollback": dict(train=[10, 9, 8, 8, 8, 8, 8, 8, 8, 8],
                                kw=dict(metrics_interval=2, patience=4,
                                        allow_rollback=False),
                                ran=8, kept=8),
    # steps of 0.2 never beat the best by min_delta 0.7 → stop after 4
    "min_delta_blocks": dict(train=[10, 9.8, 9.6, 9.4, 9.2, 9, 8.8, 8.6],
                             kw=dict(patience=3, min_delta=0.7),
                             ran=4, kept=1),
    "min_delta_small": dict(train=[10, 9.8, 9.6, 9.4, 9.2, 9, 8.8, 8.6],
                            kw=dict(patience=3, min_delta=1e-4),
                            ran=8, kept=8),
    # the training loss keeps falling, the validation loss does not: the
    # best is taken from val_loss
    "valid_monitored": dict(train=[10, 9, 8, 7, 6, 5, 4, 3],
                            valid=[5, 4, 4.5, 4.2],
                            kw=dict(metrics_interval=2, patience=2),
                            ran=6, kept=4),
    "valid_absent": dict(train=[10, 9, 8, 7, 6, 5, 4, 3],
                         kw=dict(metrics_interval=2, patience=2),
                         ran=8, kept=8),
    # patience 0 never stops (nor rolls back at the end); a trailing
    # partial window is validated too
    "no_patience": dict(train=[5, 5, 5, 5, 5], valid=[1, 2, 3],
                        kw=dict(metrics_interval=2, patience=0),
                        ran=5, kept=5),
}


@pytest.mark.parametrize("case", list(RULE))
def test_early_stopping_follows_the_jax_rule(case):
  r = RULE[case]
  m, kept = _scripted_fit(r["train"], r.get("valid"), **r["kw"])
  h = m.history
  assert len(h["loss"]) == r["ran"]
  np.testing.assert_allclose(h["loss"], r["train"][:r["ran"]])
  assert kept == r["kept"] and m.step == r["kept"] * STEPS
  windows = -(-r["ran"] // r["kw"].get("metrics_interval", 1))
  if "valid" in r:
    assert h["val_loss"] == r["valid"][:windows]
  else:
    assert "val_loss" not in h

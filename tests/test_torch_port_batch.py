"""The port's batch-covariate conditioning (``n_batch``) and SCVI's label
heads against the JAX package at converted weights and fed noise: forward,
loss, metrics and every parameter gradient on both likelihood routes (the
fused op and the distribution math), with and without the trailing batch
one-hot block (without it both condition on the uniform batch prior);
parameter shapes; ``_batch_onehot``'s level→code rule; LDVAE's loadings;
a CPU fit with validation.

Noise: the JAX module's 'sample' key is read back through the same
``apply`` and split per latent as the module splits it (as
tests/test_torch_port_zoo.py). Dropout is 0 where outputs are compared;
BatchNorm runs on batch stats. Tolerances as test_torch_port_zoo.py: loss
and metrics rtol 1e-4; gradients rtol 1e-4 with an atol of 1e-4·(largest
|gradient| of the model).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import BatchNorm
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, B, NB = 40, 5, 32, 3
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})
LAT = dict(dim=6, posterior="diag", name="latents")
SCVI_NETS = dict(NETS, encoder_l={"units": [16], "batchnorm": True})

# name → (class, outputs [(dim, posterior, name)], constructor kwargs)
CASES = {
    "scvi_nb": ("SCVI", [(G, "zinbd", "rna")],
                dict(SCVI_NETS, latents=LAT, n_batch=NB)),
    "vae_nb": ("VAE", [(G, "zinb", "rna")],
               dict(NETS, latents=LAT, n_batch=NB)),
    "ldvae_nb": ("LDVAE", [(G, "nbd", "rna")],
                 dict(latents=LAT, n_batch=NB, encoder=NETS["encoder"],
                      encoder_l=SCVI_NETS["encoder_l"])),
    "scvi_label": ("SCVI", [(G, "zinbd", "rna"), (P, "nb", "adt")],
                   dict(SCVI_NETS, latents=LAT, alpha=10.0)),
    "scvi_label_nb": ("SCVI", [(G, "zinbd", "rna"), (P, "nb", "adt")],
                      dict(SCVI_NETS, latents=LAT, alpha=10.0, n_batch=NB)),
}
# (case, whether the batch carries the one-hot block)
RUNS = [("scvi_nb", True), ("scvi_nb", False), ("vae_nb", True),
        ("vae_nb", False), ("ldvae_nb", True), ("ldvae_nb", False),
        ("scvi_label", False), ("scvi_label_nb", True)]
RUN_IDS = [f"{n}-{'block' if b else 'prior'}" for n, b in RUNS]


def _build(name, RV, zoo, **extra):
  cls, outs, kw = CASES[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0], **kw, **extra)


def _np_tree(tree):
  return None if tree is None else jax.tree_util.tree_map(
      np.asarray, jax.device_get(tree))


def _batch(name, block, seed=0, n=B):
  """Numpy batch: counts (+ protein counts) (+ the batch one-hot), a mixed
  mask, library stats."""
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  y = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P)))).astype(np.float32)
  onehot = np.eye(NB, dtype=np.float32)[rng.integers(0, NB, n)]
  mask = (rng.uniform(size=n) < 0.4).astype(np.float32)
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(n, logc.mean()), np.full(n, logc.var())],
                 1).astype(np.float32)
  inputs = [x, y][:len(CASES[name][1])] + ([onehot] if block else [])
  return {"inputs": inputs, "mask": mask, "library": lib}


def _jax_batch(b):
  return {k: ([jnp.asarray(a) for a in v] if k == "inputs"
              else jnp.asarray(v)) for k, v in b.items()}


def _torch_batch(b):
  return {k: ([torch.tensor(a) for a in v] if k == "inputs"
              else torch.tensor(v)) for k, v in b.items()}


def _random_state(jm, seed=11):
  """Random (params, batch_stats) in the layout of ``jm``'s module: the
  flax init is traced for its shapes only (running it costs seconds);
  LDVAE's zero-init ``px_r_single`` is off zero too."""
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


@functools.lru_cache(maxsize=None)
def _jax_model(name):
  jm = _build(name, JRV, J)
  return (jm,) + _random_state(jm)


def _port_model(name):
  _, params, bs = _jax_model(name)
  tm = _build(name, TRV, T, device="cpu")
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, bs))
  return tm


def _replayed_noise(jm, variables, x, rngs, latents):
  """The draws of one JAX module application with ``rngs``."""
  skey = jm.module.apply(variables, x, rngs=rngs,
                         method=lambda m, *a, **k: m.make_rng("sample"))
  keys = jax.random.split(skey, len(latents))
  return [torch.tensor(np.asarray(jax.random.normal(
      k, tuple(q.batch_shape) + tuple(q.event_shape))))
      for q, k in zip(latents, keys)]


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
def _jax_side(name, block):
  jm, params, bs = _jax_model(name)
  batch = _jax_batch(_batch(name, block))
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  (loss, (metrics, _, out)), grads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=True),
      has_aux=True))(pj)
  k1, k2 = jax.random.split(key)
  noise = _replayed_noise(jm, {"params": pj, "batch_stats": bs},
                          batch["inputs"][0], {"sample": k1, "dropout": k2},
                          out.latents)
  return dict(loss=float(loss), metrics=jax.device_get(metrics), out=out,
              grads=jax.device_get(grads), noise=noise)


def _run_port(name, block, mode, noise):
  tm = _port_model(name)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    tz.reset_launches()
    loss, metrics, out = tm._loss(_torch_batch(_batch(name, block)), True,
                                  1.0, noise=noise)
    loss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module), model=tm)


# ------------------------------------------------------------ model parity
@pytest.mark.parametrize("name,block", RUNS, ids=RUN_IDS)
def test_forward_matches_jax(name, block):
  """Output means (label heads included), latent means and draws, train
  mode, same draws."""
  j = _jax_side(name, block)
  t = _run_port(name, block, "off", j["noise"])
  close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                            atol=1e-5)
  assert len(t["out"].outputs) == len(j["out"].outputs)
  for jp, tp in zip(j["out"].outputs, t["out"].outputs):
    close(tp.mean().detach().numpy(), np.asarray(jp.mean()))
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    close(tq.mean().detach().numpy(), np.asarray(jq.mean()))
  for jz, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz))


@pytest.mark.parametrize("mode", ["off", "on"],
                         ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("name,block", RUNS, ids=RUN_IDS)
def test_loss_and_gradients_match_jax(name, block, mode):
  """Loss and metrics rtol 1e-4; every parameter gradient rtol 1e-4 with
  an atol of 1e-4·(largest |gradient| of the model). On the fused route a
  SCVI label head 'nb' takes the op too (its −1e30 gate row)."""
  j = _jax_side(name, block)
  t = _run_port(name, block, mode, j["noise"])
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


@pytest.mark.parametrize("name", ["scvi_nb", "vae_nb", "ldvae_nb"])
def test_parameter_shapes_carry_the_batch_block(name):
  """The encoders read genes + n_batch, the decoder (or LDVAE's MeanScale)
  z + n_batch, in both packages; a JAX checkpoint's leaves land in them
  without a transpose mismatch (``convert`` raises on any shape)."""
  _, params, _ = _jax_model(name)
  tm = _port_model(name)
  assert tm.n_batch == NB and tm.module.n_batch == NB
  assert params["encoder0"]["dense0"]["kernel"].shape[0] == G + NB
  assert tm.module.encoder0.dense0.weight.shape[1] == G + NB
  if name == "ldvae_nb":
    assert params["MeanScale"]["kernel"].shape == (LAT["dim"] + NB, G)
    assert tm.module.MeanScale.weight.shape == (G, LAT["dim"] + NB)
  else:
    assert params["decoder0"]["dense0"]["kernel"].shape[0] == LAT["dim"] + NB
    assert tm.module.decoder0.dense0.weight.shape[1] == LAT["dim"] + NB


def test_split_batch_takes_the_block_or_the_uniform_prior():
  tm = _port_model("vae_nb")
  x = torch.ones(4, G)
  onehot = torch.eye(NB)[[0, 2, 1, 2]]
  main, b = tm.module.split_batch(torch.cat([x, onehot], -1))
  assert torch.equal(main, x) and torch.equal(b, onehot)
  main, b = tm.module.split_batch(x)
  assert torch.equal(main, x) and torch.allclose(b, torch.full((4, NB),
                                                               1 / NB))
  with pytest.raises(ValueError, match="neither"):
    tm.module.split_batch(torch.ones(4, G + 1))
  # a trailing matrix of another width is a label, not the batch block
  assert tm._module_input([x, torch.ones(4, P)]).shape == (4, G)
  assert tm._module_input([x, onehot]).shape == (4, G + NB)


def test_ldvae_loadings_leave_out_the_batch_columns():
  """``get_loadings`` is MeanScale's z rows only, (genes, z), equal to the
  JAX one at n_batch > 0."""
  jm, params, _ = _jax_model("ldvae_nb")
  tm = _port_model("ldvae_nb")
  jm._state = TrainState(step=0, params=params, batch_stats=None,
                         opt_state=None)
  loadings = tm.get_loadings()
  assert loadings.shape == (G, LAT["dim"])
  np.testing.assert_allclose(loadings, jm.get_loadings(), atol=1e-6)


# ------------------------------------------------------- batch level codes
class _SCO:
  """The two attributes ``_batch_onehot`` reads."""

  def __init__(self, levels):
    self.obs = pd.DataFrame({"batch": list(levels)})
    self.n_obs = len(levels)


def _vae_pair(n_batch):
  kw = dict(n_batch=n_batch, seed=1, latents=LAT, **NETS)
  return (J.VAE(JRV(G, "zinb", name="rna"), **kw),
          T.VAE(TRV(G, "zinb", name="rna"), device="cpu", **kw))


def test_batch_onehot_codes_match_jax():
  """Codes fixed by the first data seen and kept in
  metadata['batch_categories']: a subset keeps its training codes, unseen
  levels are appended while n_batch has room, then it raises."""
  jm, tm = _vae_pair(4)
  rng = np.random.default_rng(3)
  first = _SCO(rng.choice(["donorB", "donorA", "donorC"], 50))
  subset = _SCO(["donorC"] * 5 + ["donorA"] * 2)
  later = _SCO(["donorD", "donorA", "donorD"])
  for sco in (first, subset, later):
    np.testing.assert_array_equal(tm._batch_onehot(sco),
                                  jm._batch_onehot(sco))
    assert tm.metadata["batch_categories"] == \
        jm.metadata["batch_categories"]
  assert tm.metadata["batch_categories"] == ["donorA", "donorB", "donorC",
                                             "donorD"]
  assert np.all(tm._batch_onehot(subset)[:5, 2] == 1.0)
  with pytest.raises(ValueError, match="exceeds n_batch=4"):
    tm._batch_onehot(_SCO(["donorE"]))
  with pytest.raises(AssertionError):
    jm._batch_onehot(_SCO(["donorE"]))
  jm2, tm2 = _vae_pair(2)
  with pytest.raises(ValueError, match="exceeds n_batch=2"):
    tm2._batch_onehot(first)
  with pytest.raises(AssertionError):
    jm2._batch_onehot(first)


def test_missing_batch_column_warns_and_uses_batch_zero():
  jm, tm = _vae_pair(2)

  class NoColumn:
    obs = pd.DataFrame({"celltype": ["a", "b", "c"]})
    n_obs = 3
  with pytest.warns(UserWarning, match="assuming one batch"):
    t = tm._batch_onehot(NoColumn())
  with pytest.warns(UserWarning, match="assuming one batch"):
    j = jm._batch_onehot(NoColumn())
  np.testing.assert_array_equal(t, j)
  assert t.shape == (3, 2) and np.all(t[:, 0] == 1.0)
  with pytest.raises(ValueError, match="n_batch=0"):
    _vae_pair(0)[1]._batch_onehot(NoColumn())


# ----------------------------------------------------------------- fitting
def test_scvi_label_head_fit_with_batch_on_cpu():
  """SCVI with an 'nb' label head at n_batch = 3: ``fit`` on [rna, adt,
  one-hot] with ``valid``, finite and falling loss, the label head's
  ``llk_x1`` and the validation keys in the history; the decoder's batch
  columns move; no kernel launched off the card."""
  b = _batch("scvi_label_nb", True, seed=3, n=192)
  data = b["inputs"]
  m = _build("scvi_label_nb", TRV, T, device="cpu")
  w0 = m.module.decoder0.dense0.weight[:, -NB:].detach().clone()
  tz.reset_launches()
  m.fit([a[:160] for a in data], valid=[a[160:] for a in data], epochs=4,
        batch_size=32, learning_rate=3e-3, metrics_interval=2,
        device_cache=True)
  h = m.history
  assert len(h["loss"]) == 4 and len(h["val_loss"]) == 2
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert "llk_x1" in h and np.isfinite(h["val_llk_x1"]).all()
  assert not torch.equal(m.module.decoder0.dense0.weight[:, -NB:], w0)
  ev = m.evaluate([a[160:] for a in data], batch_size=24)
  assert np.isfinite(list(ev.values())).all()
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}

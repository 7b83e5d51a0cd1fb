"""The port's vmapped ensemble and its member-batched ZINB kernels against
the JAX package (``sisua_tpu/train/ensemble.py``,
``sisua_tpu/models/hyper_params.py::fit_hyper_vmap``, Pallas's batching
rule over ``ops/zinb_pallas.py``).

* The op: ``torch.func.vmap`` of ``zinb_log_prob_rowsum`` and of its
  gradient against ``jax.vmap`` of the JAX op with its Pallas kernels run
  by the interpreter, for x shared or per member and θ per element or per
  gene (forward rtol 1e-4, gradients rtol 2e-4 / atol 1e-5:
  ``tests/test_ops.py``'s). The plain versions with a member axis against
  a loop over members, and the member-batched launch's arguments and
  scratch.
* One fleet step from the same converted stacked state, batch and noise
  against ``jax.vmap(model.make_train_step_core(tx))``: loss, parameters,
  BatchNorm statistics and Adam moments, with one learning rate and with
  one per member (rtol 1e-4 / atol 1e-5, the step tests' tolerance). The
  port's likelihood goes through the fused op
  (``SISUA_TPU_FUSED_LIKELIHOOD=on``), so its vmap rules run here.
* The fleet step against M single port steps on the same batch, noise and
  dropout masks (SCVI with its default dropout).
* ``VmapEnsemble`` and ``fit_hyper_vmap`` as ``tests/test_ensemble.py``
  pins them for JAX, what the ensemble refuses, and the stacked
  conversion. The other classes' fleets: ``test_torch_port_ensemble_zoo.py``,
  ``_draws.py`` and ``_all.py``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.ops import zinb_pallas as zp
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
from sisua_tpu_torch.nn import DropoutMasks, NetConf
from sisua_tpu_torch.ops import _build as kernel_build
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import ClippedAdam, VmapEnsemble
from test_torch_port_fit_surface import CLOSE, _flax_leaf, _noise
from test_torch_port_precision import pallas_interpret  # noqa: F401
from torch_port_threads import _one_thread  # noqa: F401


M, B, G = 3, 16, 40
FWD_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LRS = (1e-3, 3e-3, 1e-2)
CLIPNORM = 100.0


def _counts(n, seed=0, width=G):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.3, 1, (n, width))))
       * (rng.uniform(size=(n, width)) > 0.3)).astype(np.float32)
  x[:, 0] += 1.0
  return x


# ------------------------------------------------------------------ the op
def _op_operands(x_batched, per_gene, seed=0):
  rng = np.random.default_rng(seed)
  x = np.stack([_counts(B, seed + i) for i in range(M)])
  cr = rng.normal(0, 1, (M, 1 if per_gene else B, G)).astype(np.float32)
  lg = rng.normal(0, 1, (M, B, G)).astype(np.float32)
  gt = rng.normal(-1, 1, (M, B, G)).astype(np.float32)
  w = rng.normal(0, 1, (B,)).astype(np.float32)
  return (x if x_batched else x[0]), cr, lg, gt, w


@pytest.mark.parametrize("per_gene", [False, True], ids=["theta_BD",
                                                         "theta_gene"])
@pytest.mark.parametrize("x_batched", [False, True], ids=["x_shared",
                                                          "x_member"])
def test_vmapped_op_matches_jax_vmap(pallas_interpret, x_batched, per_gene,
                                     monkeypatch):
  """Forward and gradient of every member at once, against ``jax.vmap``
  of the Pallas kernels (Pallas's batching rule puts the members on the
  grid), float32 gradient writes in both (JAX's default is bf16)."""
  monkeypatch.setenv("SISUA_TPU_BWD_WRITES", "f32")
  x, cr, lg, gt, w = _op_operands(x_batched, per_gene)
  xa = 0 if x_batched else None

  def jloss(c, l, g, xx):
    return jnp.sum(zp.zinb_log_prob_rowsum(xx, c, l, g) * w)
  jf = jax.vmap(lambda c, l, g, xx: zp.zinb_log_prob_rowsum(xx, c, l, g),
                in_axes=(0, 0, 0, xa))(cr, lg, gt, x)
  jg = jax.vmap(jax.grad(jloss, argnums=(0, 1, 2)),
                in_axes=(0, 0, 0, xa))(cr, lg, gt, x)
  tt = [torch.tensor(a) for a in (cr, lg, gt, x)]
  tw = torch.tensor(w)

  def tloss(c, l, g, xx):
    return torch.sum(tz.zinb_log_prob_rowsum(xx, c, l, g) * tw)
  tf = torch.func.vmap(lambda c, l, g, xx: tz.zinb_log_prob_rowsum(
      xx, c, l, g), in_dims=(0, 0, 0, xa))(*tt)
  tg = torch.func.vmap(torch.func.grad(tloss, argnums=(0, 1, 2)),
                       in_dims=(0, 0, 0, xa))(*tt)
  np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=FWD_RTOL)
  for name, a, b in zip(("theta", "logits", "gate"), tg, jg):
    assert tuple(a.shape) == b.shape, name
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                               err_msg=name)


@pytest.mark.parametrize("constrained", [False, True])
def test_plain_versions_take_the_member_axis(constrained):
  """``_rowsum_ref`` and ``_grads_ref`` on (M, …) operands, a shared x
  broadcast, against a loop over members, element for element."""
  x, cr, lg, gt, _ = _op_operands(False, True, seed=3)
  x, cr, lg, gt = (torch.tensor(a) for a in (x, cr, lg, gt))
  if constrained:
    cr = torch.exp(cr)
  g = torch.tensor(np.random.default_rng(4).normal(0, 1, (M, B)),
                   dtype=torch.float32)
  xm = x.expand(M, B, G)
  out = tz._rowsum_ref(x[None], cr, lg, gt, constrained)
  grads = tz._grads_ref(xm, cr, lg, gt, g, constrained, (True,) * 3)
  for i in range(M):
    np.testing.assert_allclose(
        out[i], tz._rowsum_ref(x, cr[i], lg[i], gt[i], constrained),
        rtol=1e-6)
    for a, b in zip(grads, tz._grads_ref(x, cr[i], lg[i], gt[i], g[i],
                                         constrained, (True,) * 3)):
      assert tuple(a[i].shape) == tuple(b.shape)
      np.testing.assert_allclose(a[i], b, rtol=1e-6, atol=1e-7)


def test_member_launch_passes_strides_and_scratch(monkeypatch):
  """A member-batched call hands the C entry points M, each operand's
  member stride (0 for the shared x and a shared per-gene gate) and the
  plan for M·B rows, and allocates member-major outputs and scratch. One
  member plans exactly as the launch without the axis. Run on CPU tensors
  with the card's calls replaced by recorders."""
  b, d, m = 512, 33_000, 4
  made, calls = {}, []

  def scratch(shape, dev, dtype=torch.float32):
    t = torch.empty(shape, device=dev, dtype=dtype)
    made[t.data_ptr()] = tuple(shape)
    return t
  monkeypatch.setattr(tz, "_check_operands", lambda x, params: None)
  monkeypatch.setattr(tz, "_sm_count", lambda dev: 132)
  monkeypatch.setattr(tz, "_scratch", scratch)
  monkeypatch.setattr(tz, "_launch",
                      lambda dev, name, fn, *args: calls.append(args))
  monkeypatch.setattr(kernel_build, "load", lambda: type("L", (), dict(
      sisua_zinb_rowsum_fwd=None, sisua_zinb_rowsum_bwd=None)))
  x = torch.zeros(1, b, d)
  cr = torch.zeros(m, b, d)
  lg = torch.zeros(m, b, 2 * d)[..., :d]  # a head slice: row stride 2d
  gt = torch.zeros(1, 1, d)
  tz.reset_launches()
  tz._fwd_launch(x, cr, lg, gt, False, members=m)
  tz._bwd_launch(x, cr, lg, gt, torch.zeros(m, b), False, (True,) * 3,
                 members=m)
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  plan = tz._launch_plan(b, d, [d, 2 * d, 0], [0] * 4, 132, m=m)
  assert plan.fwd_chunks == 2  # 5 for one member: the rows fill the card
  assert tz._grids(b, d, 132, 1) == tz._grids(b, d, 132)
  fwd, bwd = calls
  mss = (0, b * d, b * 2 * d, 0)
  assert fwd[6:] == (m, b, d, *mss, d, 2 * d, 0, int(plan.vec),
                     plan.fwd_tiles, plan.fwd_chunks, 0)
  assert made[fwd[4]] == (m, b) and made[fwd[5]] == (m * b, plan.fwd_chunks)
  assert bwd[9:] == (m, b, d, *mss, d, 2 * d, 0, int(plan.vec),
                     plan.bwd_rows, plan.bwd_chunks, 0)
  assert made[bwd[8]] == (m, 3, plan.bwd_chunks, d)
  assert [made[p] for p in bwd[5:8]] == [(m, b, d), (m, b, d), (m, 1, d)]
  with pytest.raises(ValueError, match="leading axis"):
    tz._fwd_launch(torch.zeros(2, b, d), cr, lg, gt, False, members=m)


# -------------------------------------------------------- the fleet step
NETS = dict(encoder={"units": [16], "batchnorm": True},
            decoder={"units": [16], "batchnorm": True},
            latents=dict(dim=4, posterior="diag", name="latents"))
FLEETS = {
    "vae": ("VAE", (G, "zinb", "rna"), NETS),
    # SCVI without dropout: JAX's masks are not replayed here
    "scvi": ("SCVI", (G, "zinbd", "rna"),
             dict(NETS, encoder_l={"units": [8], "batchnorm": True})),
}


def _build(name, RV, zoo, **extra):
  cls, (d, post, rv_name), kw = FLEETS[name]
  return getattr(zoo, cls)(RV(d, post, name=rv_name), **dict(kw, **extra))


@functools.lru_cache(maxsize=None)
def _member_weights(name, i):
  """Random (params, batch_stats) of member ``i`` in the JAX layout."""
  jm = _build(name, JRV, J)
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(20 + i)

  def leaf(path, s):
    kind = path[-1].key
    if kind == "var":
      a = rng.uniform(0.5, 1.5, s.shape)
    elif kind == "kernel":
      a = rng.normal(0, 1 / np.sqrt(s.shape[0]), s.shape)
    elif kind == "scale":
      a = 1.0 + rng.normal(0, 0.2, s.shape)
    else:
      a = rng.normal(0, 0.2, s.shape)
    return a.astype(np.float32)
  tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
  return tree["params"], tree.get("batch_stats")


def _jax_member(name, i):
  params, stats = _member_weights(name, i)
  jm = _build(name, JRV, J)
  jm._state = TrainState(
      step=jnp.zeros((), jnp.int32),
      params=jax.tree_util.tree_map(jnp.asarray, params),
      batch_stats=None if stats is None
      else jax.tree_util.tree_map(jnp.asarray, stats), opt_state=None)
  return jm


def _step_batch(uses_library, seed=5):
  x = _counts(B, seed)
  mask = np.ones(B, np.float32)
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(B, logc.mean()), np.full(B, logc.var())],
                 1).astype(np.float32)
  jb = {"inputs": [jnp.asarray(x)], "mask": jnp.asarray(mask),
        "library": jnp.asarray(lib)}
  tb = {"inputs": [torch.tensor(x)], "mask": torch.tensor(mask)}
  if uses_library:
    tb["library"] = torch.tensor(lib)
  return jb, tb


def _adam_state(opt_state):
  """optax's ScaleByAdamState inside a stacked chain state."""
  if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
    return opt_state
  children = (opt_state.inner_state,) if hasattr(opt_state, "inner_state") \
      else opt_state if isinstance(opt_state, (tuple, list)) else ()
  for c in children:
    found = _adam_state(c)
    if found is not None:
      return found
  return None


def _batchnormed_biases(module):
  """The Dense biases a BatchNorm follows (``state_dict`` keys): their
  gradient is zero but for rounding, which Adam's first step blows up to
  ±lr in either computation."""
  names = dict(module.named_modules())
  return {f"{owner}.dense{i}.bias" for owner, m in names.items()
          for i in range(len(getattr(getattr(m, "conf", None), "units", ())))
          if f"{owner}.bn{i}" in names}


def _fleet_plan(ens, tb):
  plan = ens._draw_plan(tb)
  return plan, ens._make_step(True, "library" in tb, plan)


@pytest.mark.parametrize("rates", ["one_rate", "per_member"])
@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_step_matches_jax_vmapped_step(name, rates, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  jms = [_jax_member(name, i) for i in range(M)]
  if rates == "one_rate":
    tx = optax.chain(optax.clip_by_global_norm(CLIPNORM), optax.adam(1e-2))
    txs, lr = [tx] * M, 1e-2
  else:
    txs = [optax.chain(optax.clip_by_global_norm(CLIPNORM),
                       optax.inject_hyperparams(optax.adam)(
                           learning_rate=r)) for r in LRS]
    lr = torch.tensor(LRS)
  states = [m._state.replace(opt_state=t.init(m.params))
            for m, t in zip(jms, txs)]
  stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
  keys = jax.random.split(jax.random.key(3, impl="threefry2x32"), M)
  jb, tb = _step_batch(jms[0].uses_library)
  core = jms[0].make_train_step_core(txs[0])
  new, metrics = jax.jit(jax.vmap(core, in_axes=(0, None, 0)))(
      stacked, jb, keys)
  new = jax.device_get(new)
  draws = [_noise(m, jb, k) for m, k in zip(jms, keys)]
  noise = [torch.stack([d[j] for d in draws]) for j in range(len(draws[0]))]

  ens = VmapEnsemble(lambda s: _build(name, TRV, T, seed=s, device="cpu"),
                     n_models=M)
  host = jax.device_get(stacked)
  st = convert.jax_to_torch_stacked(ens.model.module, host.params,
                                    host.batch_stats)
  st.update(count=torch.zeros(M, dtype=torch.int32), steps=[0] * M)
  ens._stacked = st
  plan, step_fn = _fleet_plan(ens, tb)
  assert plan[1] == []  # no dropout in these nets
  loss = ens._train_step(step_fn, tb, noise, [], lr, CLIPNORM)[0]
  np.testing.assert_allclose(loss.numpy(), np.asarray(metrics["loss"]),
                             **CLOSE)
  back = convert.torch_to_jax_stacked(ens.model.module, ens._stacked)
  adam = _adam_state(new.opt_state)
  # biases ahead of a BatchNorm: held to Adam's bound |Δ| ≤ lr
  vanishing = {convert.flax_param_path(ens.model.module, k)
               for k in _batchnormed_biases(ens.model.module)}
  before = host.params
  for group, ours, theirs in (("params", back["params"], new.params),
                              ("stats", back["batch_stats"],
                               new.batch_stats),
                              ("mu", back["mu"], adam.mu),
                              ("nu", back["nu"], adam.nu)):
    flat = jax.tree_util.tree_leaves_with_path(theirs)
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat:
      keys = tuple(p.key for p in path)
      node, old = ours, before
      for k in keys:
        node = node[k]
        old = old[k] if group == "params" else None
      if group == "params" and keys in vanishing:
        for a in (node, np.asarray(leaf)):
          assert np.abs(a - old).max() <= max(LRS) * (1 + 1e-6), keys
        continue
      np.testing.assert_allclose(node, np.asarray(leaf), **CLOSE,
                                 err_msg=jax.tree_util.keystr(path))
  assert vanishing
  np.testing.assert_array_equal(ens._stacked["count"].numpy(),
                                np.asarray(adam.count))


def _scvi(seed):
  # the default nets: BatchNorm and dropout 0.1 in both encoders
  return T.SCVI(TRV(30, "zinbd", name="rna"), seed=seed, device="cpu")


@pytest.mark.parametrize("rates", ["one_rate", "per_member"])
def test_fleet_step_equals_member_steps(rates, monkeypatch):
  """Two fleet steps against two single ``_train_step``s of each member
  (its own ``ClippedAdam``) on the same batches, noise and dropout
  masks: every parameter and BatchNorm statistic, and the loss."""
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  lrs = (1e-2,) * M if rates == "one_rate" else LRS
  ens = VmapEnsemble(_scvi, n_models=M)
  singles = [_scvi(s) for s in range(M)]
  ens._stacked = ens._stack_states()
  start = {k: v.clone() for k, v in ens._stacked["params"].items()}
  x = _counts(2 * B, 7, 30)
  lib = np.stack([np.log(x.sum(1)), np.full(2 * B, 0.5)], 1)
  lr = lrs[0] if rates == "one_rate" else torch.tensor(lrs)
  for m, r in zip(singles, lrs):
    m.optimizer = ClippedAdam(m.module.parameters(), r, CLIPNORM)
  step_fn = None
  for s in range(2):
    rows = slice(s * B, (s + 1) * B)
    tb = {"inputs": [torch.tensor(x[rows])], "mask": torch.ones(B),
          "library": torch.tensor(lib[rows], dtype=torch.float32)}
    if step_fn is None:
      plan, step_fn = _fleet_plan(ens, tb)
      assert len(plan[1]) == 3  # encoder, encoder_l, decoder dropout
    noise, masks = ens._draws(plan)
    loss = ens._train_step(step_fn, tb, noise, masks, lr, CLIPNORM)[0]
    for i, m in enumerate(singles):
      base = type(m)._loss
      m._loss = (lambda batch, training, beta, _m=m, _i=i, _b=base:
                 _b(_m, batch, training, beta,
                    noise=[n[_i] for n in noise],
                    masks=DropoutMasks([k[_i] for k in masks])))
      metrics = m._train_step(tb)
      np.testing.assert_allclose(float(loss[i]),
                                 float(metrics["loss"].detach()), rtol=1e-5)
  st = ens._stacked
  vanishing = _batchnormed_biases(ens.model.module)
  assert vanishing
  for i, m in enumerate(singles):
    for k, p in m.module.named_parameters():
      if k in vanishing:  # two Adam steps: |Δ| ≤ 2 lr
        for a in (st["params"][k][i], p.detach()):
          assert (a - start[k][i]).abs().max() <= 2 * lrs[i] * (1 + 1e-6)
        continue
      np.testing.assert_allclose(st["params"][k][i], p.detach(), **CLOSE,
                                 err_msg=k)
    for k, b in m.module.named_buffers():
      np.testing.assert_allclose(st["buffers"][k][i], b, **CLOSE,
                                 err_msg=k)


# ------------------------------------------------------------- behaviour
def _vae(seed, g=G):
  return T.VAE(TRV(g, "zinb", name="rna"), seed=seed, device="cpu",
               encoder=NetConf((16,)), decoder=NetConf((16,)))


def test_vmap_ensemble():
  x = _counts(256, 1)
  ens = VmapEnsemble(_vae, n_models=3)
  ens.fit(x, epochs=3, batch_size=64)
  loss = ens.history["loss"]
  assert loss.shape == (3, 3) and ens.history["epoch_time"].shape == (3,)
  assert (loss[-1] < loss[0]).all()
  # members diverge (different init seeds) and extract as real models
  assert len(np.unique(np.round(loss[-1], 4))) > 1
  best = ens.best()
  assert best is ens.models[int(np.argmin(loss[-1]))]
  _, qZ = best.predict(x[:50])
  assert tuple(qZ.batch_shape) == (50,)
  # each member's state went back into its model, step and Adam included
  for i, m in enumerate(ens.models):
    assert m.step == 3 * 4
    for k, p in m.module.named_parameters():
      assert torch.equal(p.detach(), ens._stacked["params"][k][i])
    assert all(s["step"] == 12 for s in m.optimizer.inner.state.values())


def test_vmap_ensemble_windows_and_own_batches():
  """``shared_batches=False`` and two-epoch windows: finite (epochs, M)
  losses; a second fit continues the kept stacked state."""
  x = _counts(256, 2)
  ens = VmapEnsemble(_vae, n_models=2)
  ens.fit(x, epochs=3, batch_size=64, shared_batches=False,
          metrics_interval=2)
  assert ens.history["loss"].shape == (3, 2)
  assert np.isfinite(ens.history["loss"]).all()
  kept = ens._stacked
  ens.fit(x, epochs=1, batch_size=64)
  assert ens._stacked is kept and ens._stacked["steps"] == [16, 16]
  assert ens.history["loss"].shape == (1, 2)
  assert ens._stacked["count"].tolist() == [16, 16]


def test_vmap_ensemble_semi_supervised_sisua():
  x, y = _counts(256, 3), np.random.default_rng(3).poisson(
      5.0, (256, 4)).astype(np.float32)
  ens = VmapEnsemble(lambda s: T.SISUA(
      [TRV(G, "zinb", name="rna"), TRV(4, "nb", name="adt")], seed=s,
      device="cpu", encoder=NetConf((16,)), decoder=NetConf((16,))),
      n_models=2)
  ens.fit([x, y], epochs=3, batch_size=64, labels_percent=0.5)
  loss = ens.history["loss"]
  assert np.isfinite(loss).all() and (loss[-1] < loss[0]).all()


def test_vmapped_hyper_search(tmp_path):
  """All lr × seed trials train at once; the larger rate wins within 5
  epochs; any trial extracts as a standalone model; ``save_path`` holds
  everything but the ensemble."""
  x = _counts(256, 4)
  path = tmp_path / "hyper" / "result.json"
  res = fit_hyper_vmap(_vae, x, learning_rates=(1e-4, 3e-3),
                       seeds_per_rate=2, epochs=5, batch_size=64,
                       save_path=str(path))
  assert len(res["trials"]) == 4
  assert [t["config"]["seed"] for t in res["trials"]] == [8, 9, 8, 9]
  losses = {t["config"]["learning_rate"]: [] for t in res["trials"]}
  for t in res["trials"]:
    assert np.isfinite(t["loss"])
    losses[t["config"]["learning_rate"]].append(t["loss"])
  assert np.mean(losses[3e-3]) < np.mean(losses[1e-4])
  assert res["best"]["learning_rate"] == 3e-3
  _, qZ = res["ensemble"].extract(0).predict(x[:20])
  assert tuple(qZ.batch_shape) == (20,)
  saved = json.loads(path.read_text())
  assert set(saved) == {"best", "loss", "trials"}
  assert saved["best"] == res["best"] and saved["loss"] == res["loss"]


class _ThreeRanks:
  """A mesh's shape as ``VmapEnsemble`` reads it: 3 × 1 ranks."""
  mesh_dim_names = ("data", "model")

  def size(self, dim):
    return (3, 1)[dim]


@pytest.mark.parametrize("case", ["mesh", "lr_count"])
def test_what_the_ensemble_refuses(case):
  """Members that do not divide over the mesh's ranks raise JAX's
  assertion before any draw (the mesh fleet itself:
  tests/test_torch_port_mesh.py); a rate list of the wrong length raises
  ValueError."""
  x = _counts(128, 5)
  kw, error, match = {
      "mesh": (dict(mesh=_ThreeRanks()), AssertionError,
               "must divide evenly over the 3-device mesh"),
      "lr_count": (dict(learning_rate=[1e-3]), ValueError, "learning rates"),
  }[case]
  ens = VmapEnsemble(_vae, n_models=2)
  with pytest.raises(error, match=match):
    ens.fit(x, epochs=1, batch_size=64, **kw)


def test_stacked_conversion_round_trips():
  """JAX stacked params, batch stats and Adam moments → the port's
  stacked state → back, bitwise; member i is member i's own conversion."""
  jms = [_jax_member("vae", i) for i in range(M)]
  tx = optax.adam(1e-3)
  states = [m._state.replace(opt_state=tx.init(m.params)) for m in jms]
  host = jax.device_get(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                               *states))
  rng = np.random.default_rng(0)
  mu = jax.tree_util.tree_map(
      lambda a: rng.normal(size=a.shape).astype(np.float32), host.params)
  module = _build("vae", TRV, T, device="cpu").module
  st = convert.jax_to_torch_stacked(module, host.params, host.batch_stats,
                                    mu=mu)
  assert not any(v.any() for v in st["nu"].values())
  for i in range(M):
    one = convert.jax_to_torch(module, *_member_weights("vae", i))
    for k, v in one.items():
      group = "params" if k in st["params"] else "buffers"
      assert torch.equal(st[group][k][i], v), k
    for k, v in st["mu"].items():
      assert torch.equal(v[i], _flax_leaf(
          jax.tree_util.tree_map(lambda a: a[i], mu), module, k)), k
  back = convert.torch_to_jax_stacked(module, st)
  for ours, theirs in ((back["params"], host.params),
                       (back["batch_stats"], host.batch_stats),
                       (back["mu"], mu)):
    for path, leaf in jax.tree_util.tree_leaves_with_path(theirs):
      node = ours
      for p in path:
        node = node[p.key]
      np.testing.assert_array_equal(node, np.asarray(leaf))

"""The port's ``VmapEnsemble`` on FVAE/SemiFVAE (the discriminator step
batched over members) and SCALE/SCALAR (a mixture latent's draw fed as
Gumbel noise), against the JAX vmapped train step, and against single
port steps.

* One fleet step (M = 3) from the same stacked state, converted with
  ``convert.jax_to_torch_stacked``, against ``jax.jit(jax.vmap(core,
  in_axes=(0, None, 0)))`` of ``make_train_step_core``: the loss and
  metrics (``tc``, ``disc_loss``), the parameters, BatchNorm statistics,
  Adam's μ/ν and count, and for FactorVAE the discriminator's parameters,
  their moments and count (rtol 1e-4 / atol 1e-5; a bias ahead of a
  BatchNorm has a zero gradient but for rounding, held to Adam's |Δ| ≤ lr).
  The JAX ensemble cannot stack FactorVAE members itself (ROADMAP §C), so
  each member's state is built here, as the step needs it.
* JAX's draws are replayed per member from its threefry key: the
  latents' 'sample' key split per latent; for a mixture latent the
  categorical's Gumbel noise (``jax.random.categorical`` is the argmax of
  logits + Gumbel) and the component noise; for the discriminator step
  ``fold_in(key, 0xD15C)`` split into the eval-mode draw and the column
  permutations (``jax.random.permutation`` of each column is the column
  at the permutation of its indices).
* The fleet step against single ``_train_step``s of each member at the
  default nets (dropout on), with the same draws and masks.

The harness here is shared with ``test_torch_port_ensemble_draws.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import DropoutMasks
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import ClippedAdam, VmapEnsemble
from test_torch_port_ensemble import _adam_state, _batchnormed_biases
from test_torch_port_fit_surface import CLOSE
from torch_port_threads import _one_thread  # noqa: F401


M, B = 3, 16
G, P, C, R = 40, 5, 4, 50   # genes, proteins, cell types, peaks
LRS = (1e-3, 3e-3, 1e-2)
LR = 1e-2
CLIPNORM = 100.0
DELTA_RTOL = 2e-3  # δ's implicit gamma gradients (test_torch_port_scscope_autozi)
NET = {"units": [16], "batchnorm": True}
LAT = dict(dim=4, posterior="diag", name="latents")
NETS = dict(encoder=NET, decoder=NET, latents=LAT)

# name → (class, outputs [(dim, posterior, name)], parity kwargs (no
#         dropout), kwargs beside the default nets (dropout on))
CLASSES = {
    "fvae": ("FVAE", [(G, "zinb", "rna")],
             dict(NETS, gamma=6.0, discriminator_units=(16, 16)),
             dict(discriminator_units=(16, 16))),
    "semifvae": ("SemiFVAE", [(G, "zinb", "rna"), (P, "nb", "adt")],
                 dict(NETS, alpha=10.0, gamma=6.0,
                      discriminator_units=(16, 16)),
                 dict(discriminator_units=(16, 16))),
    "scale": ("SCALE", [(G, "zinb", "rna")],
              dict(NETS, latents=dict(LAT, posterior="mixgaus",
                                      n_components=3)), {}),
    "scalar": ("SCALAR", [(G, "zinb", "rna"), (P, "nb", "adt")],
               dict(NETS, alpha=10.0, n_components=3), {}),
    "totalvi": ("TotalVI", [(G, "zinbd", "rna"), (P, "nb", "adt")], NETS,
                {}),
    "scanvi": ("SCANVI", [(G, "zinbd", "rna"), (C, "onehot", "celltype")],
               dict(NETS, encoder_l={"units": [8], "batchnorm": True},
                    classifier={"units": [8]}, encoder_z2={"units": [8]},
                    decoder_z1={"units": [8]}), {}),
    "autozi": ("AUTOZI", [(G, "zinbd", "rna")],
               dict(NETS, encoder_l={"units": [8], "batchnorm": True}), {}),
    "multivi": ("MULTIVI", [(G, "zinbd", "rna"), (R, "bernoulli", "atac")],
                dict(encoder=(NET, {"units": [8], "batchnorm": True}),
                     decoder=(NET, {"units": [8], "batchnorm": True}),
                     depth={"units": [8]}, latents=LAT), {}),
}
ZOO = ["fvae", "semifvae", "scale", "scalar"]


def build(name, RV, zoo, default_nets=False, **extra):
  cls, outs, kw, dkw = CLASSES[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0],
                           **dict(dkw if default_nets else kw, **extra))


def _fill(shapes, rng):
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
  return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def member_weights(name, i):
  """Random (params, batch_stats, discriminator params) of member ``i`` in
  the JAX layout (the flax inits traced for their shapes only)."""
  jm = build(name, JRV, J)
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(20 + i)
  tree = _fill(dict(shapes), rng)
  aux = None
  if isinstance(jm, J.FVAE):
    aux = _fill(jax.eval_shape(lambda: jm.discriminator.init(
        key, jnp.zeros((2, jm._latent_dim()))))["params"], rng)
  return tree["params"], tree.get("batch_stats"), aux


def _jnp(tree):
  return None if tree is None else jax.tree_util.tree_map(jnp.asarray, tree)


def jax_member(name, i):
  params, stats, aux = member_weights(name, i)
  jm = build(name, JRV, J)
  jm._state = TrainState(step=jnp.zeros((), jnp.int32), params=_jnp(params),
                         batch_stats=_jnp(stats), opt_state=None,
                         aux_params=_jnp(aux), aux_opt_state=None)
  return jm


def _library(x):
  logc = np.log(x.sum(1) + 1e-8)
  return np.stack([np.full(len(x), logc.mean()),
                   np.full(len(x), logc.var())], 1).astype(np.float32)


def numpy_batch(name, seed=5, n=B):
  """Counts, the second source (proteins, cell types or peaks), a mixed
  semi-supervised mask and library statistics."""
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.3, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  x[:, 0] += 1.0
  outs = CLASSES[name][1]
  inputs = [x]
  if len(outs) > 1:
    kind = outs[1][1]
    if kind == "onehot":
      inputs.append(np.eye(C, dtype=np.float32)[rng.integers(0, C, n)])
    elif kind == "bernoulli":
      a = (rng.poisson(1.5, (n, R)) * (rng.uniform(size=(n, R)) < 0.3))
      a[:, 0] = np.maximum(a[:, 0], 2)
      a[0:3] = 0  # ATAC-absent rows: MULTIVI's gates
      inputs.append(a.astype(np.float32))
    else:
      inputs.append(rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P))))
                    .astype(np.float32))
  mask = (rng.uniform(size=n) < 0.5).astype(np.float32)
  mask[:2] = [0.0, 1.0]
  return {"inputs": inputs, "mask": mask, "library": _library(x)}


def jax_batch(b):
  return {k: ([jnp.asarray(a) for a in v] if k == "inputs"
              else jnp.asarray(v)) for k, v in b.items()}


def torch_batch(b, uses_library):
  out = {"inputs": [torch.tensor(a) for a in b["inputs"]],
         "mask": torch.tensor(b["mask"])}
  if uses_library:
    out["library"] = torch.tensor(b["library"])
  return out


def _t(a):
  return torch.tensor(np.asarray(a))


def _latent_draw(q, key):
  """A latent's standard draws under ``key`` as the port's fleet feeds
  them: a tensor, or a mixture's (Gumbel noise, component noise)."""
  if isinstance(q, JD.MixtureSameFamily):
    kc, ks = jax.random.split(key)
    shape = tuple(q.batch_shape)
    g = jax.random.gumbel(kc, shape + (q.mixture_logits.shape[-1],))
    # jax.random.categorical's own draw: argmax(logits + Gumbel)
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(g + q.mixture_logits, -1)),
        np.asarray(jax.random.categorical(kc, q.mixture_logits, axis=-1,
                                          shape=shape)))
    c = q.components
    return _t(g), _t(jax.random.normal(
        ks, tuple(c.batch_shape) + tuple(c.event_shape)))
  return _t(jax.random.normal(key, tuple(q.batch_shape)
                              + tuple(q.event_shape)))


def member_draws(jm, jb, key):
  """Every draw of member ``jm``'s JAX train step under ``key``: the
  forward's noise entries in the order the port's forward reads them,
  and the discriminator step's (eval-mode noise, then the (D, B)
  permutations), or None."""
  k1, k2 = jax.random.split(key)
  x = jm._masked_module_input(jb, True)
  variables = {"params": jm.params}
  if jm.batch_stats is not None:
    variables["batch_stats"] = jm.batch_stats
  rngs = {"sample": k1, "dropout": k2}
  kw = dict(jm._apply_kwargs(jb["library"]), training=True)
  out = jm.module.apply(variables, x, rngs=rngs, mutable=["batch_stats"],
                        **kw)[0]
  s1, s2 = jm.module.apply(
      variables, x, rngs=rngs,
      method=lambda m, *a, **k: (m.make_rng("sample"), m.make_rng("sample")))
  n = jm.n_latents
  noise = [_latent_draw(q, k)
           for q, k in zip(out.latents[:n], jax.random.split(s1, n))]
  if isinstance(jm, J.TotalVI):  # log β
    q = out.latents[n]
    noise.append(_t(jax.random.normal(
        s2, tuple(q.batch_shape) + tuple(q.event_shape))))
  elif isinstance(jm, J.SCANVI):  # z₂ of every candidate label
    noise.append(_t(jax.random.normal(
        s2, (jm.n_labels,) + tuple(out.latent_samples[0].shape))))
  elif isinstance(jm, J.AUTOZI):  # δ's (log Ga, log Gb)
    p = jm.params
    a = jnp.exp(jnp.clip(p["log_alpha_delta"], -10.0, 10.0))
    b = jnp.exp(jnp.clip(p["log_beta_delta"], -10.0, 10.0))
    seed = jax.random.bits(s2, (), jnp.uint32)
    ka, kb = jax.random.split(jax.random.key(seed, impl="threefry2x32"))
    noise.append((_t(jax.random.loggamma(ka, a)),
                  _t(jax.random.loggamma(kb, b))))
  aux = None
  if isinstance(jm, J.FVAE):
    ke, kp, kd = jax.random.split(jax.random.fold_in(key, 0xD15C), 3)
    se = jm.module.apply(variables, x, rngs={"sample": ke, "dropout": kd},
                         method=lambda m, *a, **k: m.make_rng("sample"))
    aux = [_t(jax.random.normal(k, (B, z.dim)))
           for z, k in zip(jm.latents, jax.random.split(se, n))]
    d = jm._latent_dim()
    col = jnp.arange(B, dtype=jnp.float32) * 3.0
    perms = []
    for k in jax.random.split(kp, d):
      perm = jax.random.permutation(k, B)
      np.testing.assert_array_equal(np.asarray(jax.random.permutation(k, col)),
                                    np.asarray(col[perm]))
      perms.append(perm)
    aux.append(_t(jnp.stack(perms)))
  return noise, aux


def stack_members(per_member):
  """Per-member draws (lists of tensors or pairs) → one (M, …) list."""
  def stack(entries):
    if entries[0] is None:
      return None
    if isinstance(entries[0], tuple):
      return tuple(torch.stack(e) for e in zip(*entries))
    return torch.stack(entries)
  return [stack(list(e)) for e in zip(*per_member)]


def _txs(rates):
  if rates == "one_rate":
    tx = optax.chain(optax.clip_by_global_norm(CLIPNORM), optax.adam(LR))
    return [tx] * M, LR
  return ([optax.chain(optax.clip_by_global_norm(CLIPNORM),
                       optax.inject_hyperparams(optax.adam)(
                           learning_rate=r)) for r in LRS],
          torch.tensor(LRS))


def _leaf(tree, keys):
  for k in keys:
    tree = tree[k]
  return tree


def _compare(ours, theirs, before=None, vanishing=(), loose=(), lr=LR):
  """Every leaf of the JAX tree ``theirs`` against ``ours`` (the port's,
  converted); a leaf in ``vanishing`` is held to Adam's |Δ| ≤ lr from
  ``before``, one in ``loose`` to rtol ``DELTA_RTOL``."""
  flat = jax.tree_util.tree_leaves_with_path(theirs)
  assert len(flat) == len(jax.tree_util.tree_leaves(ours))
  for path, leaf in flat:
    keys = tuple(p.key for p in path)
    node = _leaf(ours, keys)
    if keys in vanishing:
      old = _leaf(before, keys)
      for a in (node, np.asarray(leaf)):
        assert np.abs(a - old).max() <= lr * (1 + 1e-6), keys
      continue
    tol = dict(CLOSE, rtol=DELTA_RTOL) if keys[-1] in loose else CLOSE
    np.testing.assert_allclose(node, np.asarray(leaf), **tol,
                               err_msg=jax.tree_util.keystr(path))


def fleet_against_jax(name, rates="one_rate"):
  """One fleet step of ``name`` against JAX's vmapped step; every check
  of the module docstring."""
  jms = [jax_member(name, i) for i in range(M)]
  txs, lr = _txs(rates)
  aux_tx = optax.adam(jms[0]._disc_lr) if isinstance(jms[0], J.FVAE) \
      else None
  states = []
  for m, t in zip(jms, txs):
    st = m._state.replace(opt_state=t.init(m.params))
    if aux_tx is not None:
      st = st.replace(aux_opt_state=aux_tx.init(st.aux_params))
    states.append(st)
  stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
  keys = jax.random.split(jax.random.key(3, impl="threefry2x32"), M)
  b = numpy_batch(name)
  jb = jax_batch(b)
  core = jms[0].make_train_step_core(txs[0])
  new, metrics = jax.device_get(jax.jit(jax.vmap(
      core, in_axes=(0, None, 0)))(stacked, jb, keys))
  draws = [member_draws(m, jb, k) for m, k in zip(jms, keys)]
  noise = stack_members([d[0] for d in draws])
  aux_draws = None if draws[0][1] is None else stack_members(
      [d[1] for d in draws])

  ens = VmapEnsemble(lambda s: build(name, TRV, T, seed=s, device="cpu"),
                     n_models=M)
  tb = torch_batch(b, ens.model.uses_library)
  host = jax.device_get(stacked)
  st = convert.jax_to_torch_stacked(ens.model.module, host.params,
                                    host.batch_stats)
  st.update(count=torch.zeros(M, dtype=torch.int32), steps=[0] * M)
  if aux_draws is not None:
    st["aux"] = convert.jax_to_torch_stacked(ens.model.aux, host.aux_params)
    st["aux"]["count"] = torch.zeros(M, dtype=torch.int32)
  ens._stacked = st
  plan = ens._draw_plan(tb)
  assert plan.masks == []  # no dropout in these nets
  assert len(plan.noise) == len(noise)
  assert (plan.aux is None) == (aux_draws is None)
  step_fn = ens._make_step(True, "library" in tb, plan)
  loss, tmetrics, _ = ens._train_step(step_fn, tb, noise, [], lr, CLIPNORM)
  np.testing.assert_allclose(loss.numpy(), metrics["loss"], **CLOSE)

  back = convert.torch_to_jax_stacked(ens.model.module, ens._stacked)
  adam = _adam_state(new.opt_state)
  biases = _batchnormed_biases(ens.model.module)
  vanishing = {convert.flax_param_path(ens.model.module, k) for k in biases}
  assert vanishing
  top = float(max(LRS)) if rates != "one_rate" else LR
  loose = ("log_alpha_delta", "log_beta_delta") if name == "autozi" else ()
  _compare(back["params"], new.params, host.params, vanishing, lr=top)
  _compare(back["batch_stats"], new.batch_stats)
  _compare(back["mu"], adam.mu, loose=loose)
  _compare(back["nu"], adam.nu, loose=loose)
  np.testing.assert_array_equal(ens._stacked["count"].numpy(),
                                np.asarray(adam.count))
  if aux_draws is not None:
    # The discriminator step reads the updated encoder in eval mode, where
    # a bias ahead of a BatchNorm no longer cancels: its ±lr step (rounding
    # noise through Adam, in either computation) would move z. It is held
    # to JAX's step from JAX's values of those biases.
    with torch.no_grad():
      for k in biases:
        path = convert.flax_param_path(ens.model.module, k)
        ens._stacked["params"][k].copy_(_t(_leaf(new.params, path)))
    tmetrics = dict(tmetrics, disc_loss=ens._aux_train_step(
        ens._make_aux_step(True, "library" in tb, plan), aux_draws, tb))
  named = {"tc", "disc_loss"} if aux_draws is not None else set()
  assert named <= set(tmetrics) and named <= set(metrics)
  for k in set(tmetrics) & set(metrics):
    np.testing.assert_allclose(tmetrics[k].detach().numpy(), metrics[k],
                               **CLOSE, err_msg=k)
  if aux_draws is not None:
    aux_back = convert.torch_to_jax_stacked(ens.model.aux,
                                            ens._stacked["aux"])
    aux_adam = _adam_state(new.aux_opt_state)
    _compare(aux_back["params"], new.aux_params)
    _compare(aux_back["mu"], aux_adam.mu)
    _compare(aux_back["nu"], aux_adam.nu)
    np.testing.assert_array_equal(ens._stacked["aux"]["count"].numpy(),
                                  np.asarray(aux_adam.count))
    # the discriminator moved: one Adam step of ≈ its lr per entry
    for k, v in ens._stacked["aux"]["params"].items():
      moved = (v - convert.jax_to_torch_stacked(
          ens.model.aux, host.aux_params)["params"][k]).abs().max()
      assert moved > 0.5 * jms[0]._disc_lr, k


def fleet_against_singles(name, data_seed=7):
  """One fleet step of three default-net members (dropout on) against one
  single ``_train_step`` of each (its own ``ClippedAdam``, and for
  FactorVAE its discriminator's Adam) with the same batch, draws and
  dropout masks: the loss and metrics (rtol 1e-5); every gradient within
  rtol 1e-4 and 1e-6 of the member's largest |gradient|; the parameters
  after the step within ``CLOSE``, but where the gradient is rounding
  noise (below 1e-5 of the largest: the biases ahead of a BatchNorm,
  weights into a unit the batch leaves idle), which Adam's first step
  turns into ±lr in either computation: there within 2·lr; every
  BatchNorm statistic and discriminator parameter within ``CLOSE``."""
  make = lambda s: build(name, TRV, T, default_nets=True,  # noqa: E731
                         seed=s, device="cpu")
  ens = VmapEnsemble(make, n_models=M)
  singles = [make(s) for s in range(M)]
  ens._stacked = ens._stack_states()
  tb = torch_batch(numpy_batch(name, data_seed), ens.model.uses_library)
  plan = ens._draw_plan(tb)
  assert plan.masks, "the default nets have dropout"
  step_fn = ens._make_step(True, "library" in tb, plan)
  aux_fn = ens._make_aux_step(True, "library" in tb, plan)
  noise, masks = ens._draws(plan)
  aux_draws = None if aux_fn is None else ens._aux_draws(plan)
  loss, metrics, grads = ens._train_step(
      step_fn, tb, noise, masks, LR, CLIPNORM,
      None if aux_fn is None else (aux_fn, aux_draws))
  st = ens._stacked
  member = ens._member_draws
  for i, m in enumerate(singles):
    start = {k: p.detach().clone() for k, p in m.module.named_parameters()}
    m.optimizer = ClippedAdam(m.module.parameters(), LR, CLIPNORM)
    base = type(m)._loss
    m._loss = (lambda batch, training, beta, _m=m, _i=i, _b=base:
               _b(_m, batch, training, beta, noise=member(noise, _i),
                  masks=DropoutMasks([k[_i] for k in masks])))
    if aux_fn is not None:
      m.aux_optimizer = m._make_aux_optimizer()
      step = type(m)._aux_step
      mine = member(aux_draws, i)
      m._aux_step = (lambda batch, mets, _m=m, _s=step, _d=mine:
                     _s(_m, batch, mets, noise=_d[:-1], perms=_d[-1]))
    seen = {}  # the gradients before the clip, which rescales them in place

    def step(_m=m, _step=m.optimizer.step):
      seen.update((k, p.grad.clone()) for k, p in _m.module.named_parameters())
      _step()
    m.optimizer.step = step
    got = m._train_step(tb)
    assert set(got) == set(metrics)
    for k, v in got.items():
      np.testing.assert_allclose(float(metrics[k][i]), float(v.detach()),
                                 rtol=1e-5, atol=1e-6, err_msg=k)
    top = max(float(g.abs().max()) for g in seen.values())
    for k, p in m.module.named_parameters():
      g = seen[k]
      np.testing.assert_allclose(grads[k][i], g, rtol=1e-4, atol=1e-6 * top,
                                 err_msg=k)
      noisy = g.abs() < 1e-5 * top
      fleet, single = st["params"][k][i], p.detach()
      for moved in (fleet - start[k], single - start[k]):  # f32 rounding
        assert (moved.abs() <= LR + 1e-6).all(), k
      np.testing.assert_allclose(fleet[~noisy], single[~noisy], **CLOSE,
                                 err_msg=k)
    for k, b in m.module.named_buffers():
      np.testing.assert_allclose(st["buffers"][k][i], b, **CLOSE, err_msg=k)
    if aux_fn is not None:
      for k, p in m.aux.named_parameters():
        np.testing.assert_allclose(st["aux"]["params"][k][i], p.detach(),
                                   **CLOSE, err_msg=k)


@pytest.mark.parametrize("name", ZOO)
def test_fleet_step_matches_jax_vmapped_step(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_jax(name)


def test_fvae_fleet_with_per_member_rates_matches_jax(monkeypatch):
  """Two optimizers: the main one with a rate per member
  (``inject_hyperparams``), the discriminator's at its own rate."""
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_jax("fvae", "per_member")


@pytest.mark.parametrize("name", ZOO)
def test_fleet_step_equals_member_steps(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_singles(name)

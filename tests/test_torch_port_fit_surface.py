"""The rest of ``fit``'s surface in the port against the JAX package.

* The seven optax optimizers (``train/optim.py``): a 5-step parameter
  trajectory from one gradient sequence, with and without the global-norm
  clip, and one model step each, against optax through the JAX trainer's
  ``make_optimizer``.
* ``freeze`` / ``fit_query``: one masked step (trainable leaves equal,
  the clip over them alone, BatchNorm statistics of frozen modules moving,
  ``grad_norm`` over every leaf), the optimizer state's life across calls,
  the refusal of a prefix that matches nothing, ``fit_query``'s frozen set.
  The JAX package's frozen leaves are NOT left alone: ``optax.masked``
  passes a masked-out leaf's update through unchanged, so
  ``apply_updates`` adds its raw gradient. The port gives them no update,
  as the JAX docstring says; the test pins both.
* ``mc_samples``: the step loss and gradients at S = 3 for VAE and SCALE
  (mixture latent) at the same replayed noise; a 'tril' latent draw by
  draw (JAX raises there).
* ``callbacks`` (order and injected metrics against JAX's device-resident
  fit), ``checkpoint_path``, ``track_gradient_norms``, ``device_dtype``,
  ``profile_dir``, the arguments of later ROADMAP items, and a second
  ``fit`` taking its own learning rate.
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
from sisua_tpu.train.trainer import Trainer as JTrainer
from sisua_tpu.train.trainer import TrainingCallback as JCallback
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import ClippedOptimizer, Trainer, TrainingCallback
from torch_port_threads import _one_thread  # noqa: F401


G, P, B = 30, 4, 32
OPTIMIZERS = ["adam", "adamw", "sgd", "rmsprop", "adamax", "adafactor",
              "lion"]
CLOSE = dict(rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------- optimizers
@pytest.mark.parametrize("clipnorm", [0.0, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_trajectory_matches_optax(name, clipnorm):
  """Five steps from one gradient sequence: every parameter equals optax's
  at rtol 1e-5, with an atol of 1e-6·max|param| for entries near 0 (the
  two evaluate the same update in another order, a few f32 ulps; as
  ``test_clipped_adam_matches_optax``). Adafactor gets one factored leaf
  (both dims ≥ 128) and small ones; the clip (norm 1 against gradients of
  norm ~100) is on or off."""
  rng = np.random.default_rng(OPTIMIZERS.index(name))
  shapes = {"big": (130, 128), "small": (5, 3), "vec": (7,)}
  params = {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}
  grads = [{k: rng.normal(0, 1, s).astype(np.float32) for k, s in
            shapes.items()} for _ in range(5)]
  tx = JTrainer(None, None, optimizer=name, learning_rate=1e-2,
                clipnorm=clipnorm).make_optimizer()
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  state = tx.init(jp)
  tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
  opt = Trainer(optimizer=name, learning_rate=1e-2,
                clipnorm=clipnorm).make_optimizer(list(tp.values()))
  for g in grads:
    upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
    jp = optax.apply_updates(jp, upd)
    for k, p in tp.items():
      p.grad = torch.tensor(g[k])
    opt.step()
    for k, p in tp.items():
      ref = np.asarray(jp[k])
      np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-5,
                                 atol=1e-6 * float(np.abs(ref).max()),
                                 err_msg=k)


NETS = dict(encoder={"units": [16], "batchnorm": True},
            decoder={"units": [16], "batchnorm": True},
            latents=dict(dim=4, posterior="diag", name="latents"))
PLAIN_NETS = dict(encoder={"units": [16]}, decoder={"units": [16]},
                  latents=dict(dim=4, posterior="diag", name="latents"))
MODELS = {
    "vae": ("VAE", [(G, "zinb", "rna")], NETS),
    "vae_plain": ("VAE", [(G, "zinb", "rna")], PLAIN_NETS),
    "scale": ("SCALE", [(G, "zinb", "rna")],
              dict(PLAIN_NETS, latents=dict(dim=4, posterior="mixgaus",
                                            n_components=3,
                                            name="latents"))),
    "scvi": ("SCVI", [(G, "zinbd", "rna")], {}),
    "sisua": ("SISUA", [(G, "zinb", "rna"), (P, "nb", "adt")], {}),
    "totalvi": ("TotalVI", [(G, "zinbd", "rna"), (P, "nb", "adt")], {}),
}


def _build(name, RV, zoo, **extra):
  cls, outs, kw = MODELS[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0],
                           **dict(kw, **extra))


def _counts(n=B, seed=0, width=G):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.3, 1, (n, width))))
       * (rng.uniform(size=(n, width)) > 0.3)).astype(np.float32)
  x[:, 0] += 1.0
  return x


@functools.lru_cache(maxsize=None)
def _weights(name):
  """Random (params, batch_stats) in the JAX module's layout (the flax init
  traced for its shapes only)."""
  jm = _build(name, JRV, J)
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(9)

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


def _jax_model(name, **extra):
  params, stats = _weights(name)
  jm = _build(name, JRV, J, **extra)
  jm._state = TrainState(
      step=jnp.zeros((), jnp.int32),
      params=jax.tree_util.tree_map(jnp.asarray, params),
      batch_stats=None if stats is None
      else jax.tree_util.tree_map(jnp.asarray, stats), opt_state=None)
  return jm


def _port_model(name, **extra):
  params, stats = _weights(name)
  tm = _build(name, TRV, T, device="cpu", **extra)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return tm


def _draw(q, key, sample_shape):
  """A JAX latent's standard draws for ``sample(key, sample_shape)``, as
  the port's ``eps``."""
  lead = tuple(sample_shape)
  if isinstance(q, JD.MixtureSameFamily):
    kc, ks = jax.random.split(key)
    k = jax.random.categorical(kc, q.mixture_logits, axis=-1,
                               shape=lead + tuple(q.batch_shape))
    c = q.components
    eps = jax.random.normal(ks, lead + tuple(c.batch_shape)
                            + tuple(c.event_shape))
    return torch.tensor(np.asarray(k)), torch.tensor(np.asarray(eps))
  return torch.tensor(np.asarray(jax.random.normal(
      key, lead + tuple(q.batch_shape) + tuple(q.event_shape))))


def _batches(name, seed=0):
  x = _counts(seed=seed)
  inputs = [x]
  if len(MODELS[name][1]) > 1:
    inputs.append(np.random.default_rng(seed + 1).poisson(
        6.0, (B, P)).astype(np.float32))
  mask = np.ones(B, np.float32)
  mask[::3] = 0.0
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(B, logc.mean()), np.full(B, logc.var())],
                 1).astype(np.float32)
  b = {"inputs": inputs, "mask": mask, "library": lib}
  jb = {k: ([jnp.asarray(a) for a in v] if k == "inputs"
            else jnp.asarray(v)) for k, v in b.items()}
  tb = {k: ([torch.tensor(a) for a in v] if k == "inputs"
            else torch.tensor(v)) for k, v in b.items()}
  return jb, tb


def _noise(jm, batch, key, sample_shape=()):
  """The draws of JAX's training forward under ``key`` (its 'sample' key
  read back and split per latent)."""
  k1, k2 = jax.random.split(key)
  variables = {"params": jm.params}
  if jm.batch_stats is not None:
    variables["batch_stats"] = jm.batch_stats
  x = jm._module_input(batch["inputs"])
  kw = dict(jm._apply_kwargs(batch["library"]), training=True)
  if sample_shape:
    kw["sample_shape"] = tuple(sample_shape)
  out = jm.module.apply(variables, x, rngs={"sample": k1, "dropout": k2},
                        mutable=["batch_stats"], **kw)[0]
  skey = jm.module.apply(variables, x, rngs={"sample": k1, "dropout": k2},
                         method=lambda m, *a, **k: m.make_rng("sample"))
  n = len(out.latents)
  return [_draw(q, k, sample_shape)
          for q, k in zip(out.latents, jax.random.split(skey, n))]


def _feed(tm, noise):
  """``tm``'s training steps draw ``noise`` instead of its generator."""
  base = type(tm)._loss
  tm._loss = lambda batch, training, beta, noise_=None: base(
      tm, batch, training, beta, noise=noise)


def _jax_step(jm, tx, batch, key, track=False):
  jm._track_grad_norms = track
  state = jm._state.replace(opt_state=tx.init(jm.params))
  new, metrics = jax.jit(jm.make_train_step_core(tx))(state, batch, key)
  return jax.device_get(new), jax.device_get(metrics)


def _flax_leaf(tree, module, key):
  node = tree
  for part in convert.flax_param_path(module, key):
    node = node[part]
  t = torch.tensor(np.asarray(node))
  return convert._reversed_axes(t) if t.ndim > 1 else t


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_model_step_per_optimizer_matches_jax(name):
  """One VAE train step (no BatchNorm: every gradient is well away from 0,
  so Lion's signs agree) with each optimizer after the clip: every updated
  parameter equals JAX's."""
  jm = _jax_model("vae_plain")
  tm = _port_model("vae_plain")
  jb, tb = _batches("vae_plain")
  key = jax.random.key(5, impl="rbg")
  trainer = JTrainer(None, None, optimizer=name, learning_rate=1e-2,
                     clipnorm=10.0)
  new, _ = _jax_step(jm, trainer.make_optimizer(), jb, key)
  _feed(tm, _noise(jm, jb, key))
  tm._fit_optimizer(Trainer(optimizer=name, learning_rate=1e-2,
                            clipnorm=10.0), ())
  tm._train_step(tb)
  for k, p in tm.module.named_parameters():
    np.testing.assert_allclose(p.detach(), _flax_leaf(new.params, tm.module,
                                                      k), **CLOSE,
                               err_msg=k)


# ------------------------------------------------------------------ freeze
def _jax_masked_tx(jm, freeze, clipnorm):
  """The JAX ``fit``'s masked transform for ``freeze`` (SGD at 0.1)."""
  def trainable(path, _):
    comps = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
    return not any(c.startswith(f) for c in comps for f in freeze)
  mask = jax.tree_util.tree_map_with_path(trainable, jm.params)
  tx = JTrainer(None, None, optimizer="sgd", learning_rate=0.1,
                clipnorm=clipnorm).make_optimizer()
  return optax.masked(tx, mask)


def test_freeze_step_matches_jax_on_trainable_leaves():
  """One SGD step with ``freeze=('decoder',)`` and a clip that bites (SGD:
  the biases ahead of a BatchNorm have a vanishing gradient, whose rounding
  noise Adam would blow up to ±lr): the trainable leaves equal JAX's (so
  the clip's norm counts them alone); the
  port leaves frozen ones bitwise unchanged while JAX adds their raw
  gradient (optax.masked passes their update through); BatchNorm
  statistics move in frozen modules too; ``grad_norm`` is the pre-clip
  norm over every leaf."""
  freeze = ("decoder",)
  jm = _jax_model("vae")
  tm = _port_model("vae")
  jb, tb = _batches("vae")
  key = jax.random.key(6, impl="rbg")
  new, jmet = _jax_step(jm, _jax_masked_tx(jm, freeze, 1.0), jb, key,
                        track=True)
  before = {k: v.detach().clone() for k, v in tm.module.state_dict().items()}
  _feed(tm, _noise(jm, jb, key))
  tm._fit_optimizer(Trainer(optimizer="sgd", learning_rate=0.1,
                            clipnorm=1.0), freeze)
  tm._track_grad_norms = True
  metrics = tm._train_step(tb)
  np.testing.assert_allclose(float(metrics["grad_norm"]),
                             float(jmet["grad_norm"]), rtol=1e-5)
  assert float(metrics["grad_norm"]) > 1.0  # the clip bites
  frozen = trainable = 0
  for k, p in tm.module.named_parameters():
    ref = _flax_leaf(new.params, tm.module, k)
    if convert.flax_param_path(tm.module, k)[0].startswith("decoder"):
      frozen += 1
      assert torch.equal(p.detach(), before[k]), k
      np.testing.assert_allclose(  # the port's gradient, computed anyway
          ref, before[k] + p.grad, rtol=1e-4, atol=1e-5,
          err_msg=f"JAX's frozen {k}")
    else:
      trainable += 1
      np.testing.assert_allclose(p.detach(), ref, **CLOSE, err_msg=k)
  assert frozen and trainable
  for k, b in tm.module.named_buffers():
    assert not torch.equal(b, before[k]), k  # the decoder's BN too
    np.testing.assert_allclose(b, _flax_leaf(new.batch_stats, tm.module,
                                             k.replace("running_mean", "mean")
                                             .replace("running_var", "var")),
                               rtol=1e-5, atol=1e-6, err_msg=k)


def test_freeze_state_lives_while_the_freeze_set_does():
  """Optimizer state exists for the trainable leaves only; it carries over
  a second call with the same freeze set (and the same optimizer) and
  starts afresh when the set changes; a prefix matching nothing raises,
  as it does in JAX."""
  tm = _port_model("vae")
  x = _counts(64)
  tm.fit(x, epochs=1, batch_size=32, freeze=("decoder",), device_cache=True)
  n_trainable = sum(1 for k, _ in tm.module.named_parameters()
                    if not k.startswith("decoder"))
  state = tm.optimizer.state_dict()["state"]
  assert len(state) == n_trainable
  assert all(int(s["step"]) == 2 for s in state.values())
  tm.fit(x, epochs=1, batch_size=32, freeze=("decoder",), device_cache=True)
  assert all(int(s["step"]) == 4
             for s in tm.optimizer.state_dict()["state"].values())
  tm._fit_optimizer(Trainer(), ("encoder",))
  assert tm.optimizer.state_dict()["state"] == {}
  with pytest.raises(ValueError, match="matched no parameters"):
    tm.fit(x, epochs=1, batch_size=32, freeze=("nothing_here",),
           device_cache=True)
  jm = _jax_model("vae")
  with pytest.raises(AssertionError, match="matched no parameters"):
    jm.fit(x, epochs=1, batch_size=32, device_cache=True,
           freeze=("nothing_here",))


@pytest.mark.parametrize("name", ["scvi", "sisua", "totalvi"])
def test_fit_query_freezes_what_jax_freezes(name, monkeypatch):
  """``fit_query``'s frozen set (every top-level group but the encoders and
  latent heads) is JAX's, and those groups' leaves get no update."""
  seen = {}
  jm = _jax_model(name)
  monkeypatch.setattr(jm, "fit", lambda q, freeze=(), **kw:
                      seen.setdefault("jax", freeze))
  jm.fit_query(None)
  tm = _port_model(name)
  monkeypatch.setattr(tm, "fit", lambda q, freeze=(), **kw:
                      seen.setdefault("port", freeze))
  tm.fit_query(None)
  assert seen["port"] == seen["jax"] and seen["port"]
  with pytest.raises(ValueError, match="must split"):
    tm.fit_query(None, train_keys=("nothing",))


# ------------------------------------------------------------- mc_samples
@pytest.mark.parametrize("name", ["vae_plain", "scale"])
def test_mc_samples_step_matches_jax(name):
  """``mc_samples=3``: three draws per cell in training (the likelihood
  and an MC KL averaged over them, the fused op bypassed in both), loss
  and gradients equal JAX's at the same replayed draws."""
  jm = _jax_model(name)
  jm._train_mc_samples = 3
  tm = _port_model(name)
  tm._train_mc_samples = 3
  jb, tb = _batches(name)
  key = jax.random.key(8, impl="rbg")
  (jloss, (jmet, _, jout)), jgrads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, jm.batch_stats, jb, key, 1.0, training=True),
      has_aux=True))(jm.params)
  assert jout.latent_samples[0].shape[0] == 3
  loss, metrics, out = tm._loss(tb, True, 1.0,
                                noise=_noise(jm, jb, key, (3,)))
  loss.backward()
  assert out.latent_samples[0].shape[0] == 3
  np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
  for k in jmet:
    np.testing.assert_allclose(float(metrics[k].detach()), float(jmet[k]),
                               rtol=1e-4, atol=1e-5, err_msg=k)
  jgrads = jax.device_get(jgrads)
  for k, p in tm.module.named_parameters():
    np.testing.assert_allclose(p.grad, _flax_leaf(jgrads, tm.module, k),
                               **CLOSE, err_msg=k)


def test_mc_samples_tril_latent_draw_by_draw():
  """A 'tril' latent at ``mc_samples=3`` (JAX's MVN-TriL log_prob raises on
  sample dims, ROADMAP §C): the S = 3 loss is the mean of the three
  single-draw losses at the same draws (no BatchNorm in the decoder,
  whose statistics would pool the draws)."""
  tm = _build("vae_plain", TRV, T, device="cpu",
              latents=dict(dim=3, posterior="tril", name="latents"))
  _, tb = _batches("vae_plain")
  eps = torch.randn((3, B, 3), generator=torch.Generator().manual_seed(0))
  tm._train_mc_samples = 3
  with torch.no_grad():
    l3, m3, _ = tm._loss(tb, True, 1.0, noise=[eps])
    tm._train_mc_samples = 1
    singles = [tm._loss(tb, True, 1.0, noise=[eps[s]]) for s in range(3)]
  np.testing.assert_allclose(float(l3), np.mean([float(s[0])
                                                 for s in singles]),
                             rtol=1e-5)
  for k in m3:
    if k != "beta":
      np.testing.assert_allclose(float(m3[k]), np.mean(
          [float(s[1][k]) for s in singles]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ callbacks & co.
class _Recorder:
  """The same recording callback on both sides: every call in order, and
  one metric injected at the epoch's begin and one at its end."""

  def __init__(self):
    self.calls = []

  def set_model(self, model):
    self.calls.append(("set_model",))

  def on_epoch_begin(self, epoch, logs):
    self.calls.append(("begin", epoch))
    logs["begun"] = float(epoch)

  def on_epoch_end(self, epoch, logs):
    self.calls.append(("end", epoch, sorted(logs)))
    logs["ended"] = 10.0 + epoch

  def on_train_end(self, logs):
    self.calls.append(("train_end", sorted(logs)))


class _PortRecorder(_Recorder, TrainingCallback):
  pass


class _JaxRecorder(_Recorder, JCallback):
  pass


def test_callbacks_follow_jax_order_and_land_in_history():
  """Five epochs in windows of 2 (the last window of one): the same calls
  in the same order as JAX's device-resident fit, and the injected
  metrics in ``history`` per epoch."""
  x = _counts(64)
  jm, tm = _jax_model("vae"), _port_model("vae")
  jcb, tcb = _JaxRecorder(), _PortRecorder()
  kw = dict(epochs=5, batch_size=32, metrics_interval=2)
  jm.fit(x, valid=x, callbacks=[jcb], device_cache=True, **kw)
  tm.fit(x, valid=x, callbacks=[tcb], **kw, device_cache=True)
  assert tcb.calls == jcb.calls
  for k in ("begun", "ended"):
    assert tm.history[k] == list(jm.history[k]) and len(tm.history[k]) == 5


def test_checkpoint_path_holds_the_rolled_back_best(tmp_path, monkeypatch):
  """The weights are written at each new best; after an early stop with
  rollback the file reloads to the model as it was rolled back."""
  tm = _port_model("vae")
  losses = iter([5.0, 4.0, 4.5, 4.6, 4.7, 4.8])
  real = tm._train_step
  writes = []
  monkeypatch.setattr(tm, "_save_checkpoint_weights",
                      lambda p, f=tm._save_checkpoint_weights:
                      (writes.append(tm.step), f(p)))

  def step(batch):
    m = real(batch)
    m["loss"] = torch.tensor(losses_by_epoch[(tm.step - 1) // 2])
    return m
  losses_by_epoch = list(losses)
  tm._train_step = step
  tm.fit(_counts(64), epochs=6, batch_size=32, patience=2,
         checkpoint_path=str(tmp_path), device_cache=True)
  assert writes == [2, 4] and tm.step == 4 and len(tm.history["loss"]) == 4
  fresh = _port_model("vae")
  fresh.load_weights(str(tmp_path), raise_notfound=True)
  for k, v in tm.module.state_dict().items():
    assert torch.equal(v, fresh.module.state_dict()[k]), k


def test_track_gradient_norms_averages_the_step_norms():
  """``grad_norm`` in the history: the mean over an epoch's steps of the
  pre-clip global norm."""
  tm = _port_model("vae")
  norms = []
  real = tm._train_step

  def step(batch):
    m = real(batch)
    norms.append(float(m["grad_norm"]))
    return m
  tm._train_step = step
  tm.fit(_counts(96), epochs=2, batch_size=32, track_gradient_norms=True,
         clipnorm=1.0, device_cache=True)
  np.testing.assert_allclose(tm.history["grad_norm"],
                             [np.mean(norms[:3]), np.mean(norms[3:])],
                             rtol=1e-6)
  assert min(norms) > 1.0  # pre-clip


def test_device_dtype_storage():
  """'int16' trains bitwise like float32 on integral counts with half the
  resident bytes and refuses non-integral counts with JAX's message;
  'bfloat16' stores the bf16-rounded counts and trains like float32 on
  them."""
  x = _counts(64)
  fits = {}
  for dd in ("float32", "int16"):
    tm = _port_model("vae")
    tm.fit(x, epochs=2, batch_size=32, device_dtype=dd, device_cache=True)
    fits[dd] = tm
  assert fits["int16"].history["loss"] == fits["float32"].history["loss"]
  for k, v in fits["int16"].module.state_dict().items():
    assert torch.equal(v, fits["float32"].module.state_dict()[k]), k
  tr = Trainer(device_dtype="int16")
  (stored,) = tr.resident([torch.tensor(x)])
  assert stored.dtype == torch.int16 and stored.element_size() == 2
  frac = x + 0.5
  with pytest.raises(ValueError) as port_err:
    _port_model("vae").fit(frac, epochs=1, batch_size=32,
                           device_dtype="int16", device_cache=True)
  with pytest.raises(ValueError) as jax_err:
    _jax_model("vae").fit(frac, epochs=1, batch_size=32, device_cache=True,
                          device_dtype="int16")
  assert str(port_err.value) == str(jax_err.value)
  y = x * 1.37
  (bf,) = Trainer(device_dtype="bfloat16").resident([torch.tensor(y)])
  assert torch.equal(bf, torch.tensor(y).to(torch.bfloat16))
  a, b = _port_model("vae"), _port_model("vae")
  a.fit(y, epochs=1, batch_size=32, device_dtype="bfloat16", device_cache=True)
  b.fit(bf.float().numpy(), epochs=1, batch_size=32, device_cache=True)
  assert a.history["loss"] == b.history["loss"]


def test_profile_dir_writes_a_trace(tmp_path):
  tm = _port_model("vae_plain")
  tm.fit(_counts(32), epochs=1, batch_size=32, profile_dir=str(tmp_path),
         device_cache=True)
  assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("kw", [dict(scan_steps=4), dict(mesh=object())],
                         ids=["scan_steps", "mesh"])
def test_later_items_raise(kw):
  """The arguments of loops that came later work (``transfer_dtype`` and
  ``hbm_budget_bytes`` since the streaming and out-of-core loops came:
  ``tests/test_torch_port_out_of_core.py``). ``scan_steps`` (A5a) trains,
  in whole chunks of 4 steps (``tests/test_torch_port_scan_steps.py``
  holds it to JAX); ``mesh`` (A21) trains over a world's mesh."""
  model = _port_model("vae_plain")
  if "scan_steps" in kw:
    model.fit(_counts(160), epochs=1, batch_size=32, **kw)
    assert model.step == 4 and np.isfinite(model.history["loss"]).all()
    return
  # the mesh (A21) is ported: a fit over a one-rank mesh is the
  # single-device fit, bitwise (tests/test_torch_port_mesh.py holds the
  # 2 × 2 mesh); without a world a mesh cannot be made
  import torch_port_mesh_ranks as ranks
  from sisua_tpu_torch.parallel import create_mesh, spawn
  with pytest.raises(RuntimeError, match="torchrun"):
    model.fit(_counts(32), epochs=1, batch_size=32, mesh=create_mesh())
  out = spawn(ranks.one_rank, 1, timeout=120)[0]
  assert out["mesh"]["loss"] == out["single"]["loss"]


def test_a_second_fit_takes_its_own_learning_rate():
  """As the JAX ``fit``, each call builds its optimizer from its own
  arguments and carries the state over: ``learning_rate=0`` leaves every
  parameter where the first fit left it (the port used to keep the first
  call's optimizer, rate and all)."""
  tm = _port_model("vae_plain")
  x = _counts(64)
  tm.fit(x, epochs=1, batch_size=32, learning_rate=1e-2, device_cache=True)
  after = {k: v.detach().clone() for k, v in tm.module.named_parameters()}
  tm.fit(x, epochs=1, batch_size=32, learning_rate=0.0, device_cache=True)
  for k, v in tm.module.named_parameters():
    assert torch.equal(v, after[k]), k
  assert tm.step == 4
  assert isinstance(tm.optimizer, ClippedOptimizer)
  tm.fit(x, epochs=1, batch_size=32, optimizer="sgd", learning_rate=0.0,
         device_cache=True)
  assert tm.optimizer.name == "sgd"

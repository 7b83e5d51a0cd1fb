"""The port's SCALE/SCALAR, FVAE/SemiFVAE and LDVAE against the JAX
package at converted weights: the 'tril'/'mixtril'/'mixgaus' distributions
and the triangular packing, forward, loss and every parameter gradient,
FactorVAE's TC term and one discriminator update, LDVAE's loadings and
identity decoder, and short CPU fits with validation and rollback.

Noise: the JAX forward's draws are replayed, not recovered from z. The
module's 'sample' key is read back through the same ``apply`` (its first
``make_rng('sample')``), split per latent as the JAX module splits it, and
each latent's draw is redone from its key: the standard noise of a
Gaussian latent, and for a mixture latent the categorical component
indices and every component's noise, the pair the port's
``MixtureSameFamily.rsample`` takes. FactorVAE's discriminator step
replays ``fold_in(key, 0xD15C)`` the same way; its permutations are read
off the permuted latents. Dropout is 0 where outputs are compared;
BatchNorm runs on batch stats.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
import sisua_tpu.rv as jrv
from sisua_tpu.models import fvae as jfvae
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import dist as D
from sisua_tpu_torch import models as T
from sisua_tpu_torch import rv as trv
from sisua_tpu_torch.models import fvae as tfvae
from sisua_tpu_torch.nn import BatchNorm, NetConf
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, B = 50, 5, 32
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})
LAT = dict(dim=6, posterior="diag", name="latents")
TWO_OUT = [(G, "zinb", "rna"), (P, "nb", "adt")]

# name → (class, outputs [(dim, posterior, name)], constructor kwargs)
CASES = {
    "scale": ("SCALE", [(G, "zinb", "rna")],
              dict(NETS, latents=dict(LAT, posterior="mixgaus",
                                      n_components=3))),
    "scale_mixtril": ("SCALE", [(G, "zinb", "rna")],
                      dict(NETS, latents=dict(LAT, dim=4,
                                              posterior="mixtril",
                                              n_components=3))),
    "scalar": ("SCALAR", TWO_OUT,
               dict(NETS, latents=LAT, alpha=10.0, n_components=4)),
    "fvae": ("FVAE", [(G, "zinb", "rna")],
             dict(NETS, latents=LAT, gamma=6.0,
                  discriminator_units=(16, 16, 16))),
    "semifvae": ("SemiFVAE", TWO_OUT,
                 dict(NETS, latents=LAT, alpha=10.0, gamma=6.0,
                      discriminator_units=(16, 16, 16))),
    "ldvae_single": ("LDVAE", [(G, "nbd", "rna")],
                     dict(latents=LAT, dispersion="single",
                          encoder={"units": [32, 32], "batchnorm": True},
                          encoder_l={"units": [16], "batchnorm": True})),
    "ldvae_full": ("LDVAE", [(G, "nbd", "rna")],
                   dict(latents=LAT, dispersion="full",
                        encoder={"units": [32, 32], "batchnorm": True},
                        encoder_l={"units": [16], "batchnorm": True})),
}
FVAES = ["fvae", "semifvae"]


def _build(name, RV, zoo, **extra):
  cls, outs, kw = CASES[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0], **kw, **extra)


def _np_tree(tree):
  return None if tree is None else jax.tree_util.tree_map(
      np.asarray, jax.device_get(tree))


def _batch(name, seed=0, n=B):
  """Numpy batch: counts (+ protein counts), a mixed mask, library stats."""
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  y = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P)))).astype(np.float32)
  mask = (rng.uniform(size=n) < 0.4).astype(np.float32)
  mask[:2] = [0.0, 1.0]
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(n, logc.mean()), np.full(n, logc.var())],
                 1).astype(np.float32)
  out = {"inputs": [x, y][:len(CASES[name][1])], "mask": mask}
  if CASES[name][0] == "LDVAE":
    out["library"] = lib
  return out


def _jax_batch(b):
  return {k: ([jnp.asarray(a) for a in v] if k == "inputs"
              else jnp.asarray(v)) for k, v in b.items()}


def _torch_batch(b):
  return {k: ([torch.tensor(a) for a in v] if k == "inputs"
              else torch.tensor(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
  jm = _build(name, JRV, J)
  jm._ensure_initialized()
  params = _np_tree(jm.params)
  if "px_r_single" in params:  # off its zero init, so its gradient shows
    params["px_r_single"] = np.random.default_rng(1).normal(
        0, 0.5, G).astype(np.float32)
  return jm, params, _np_tree(jm.batch_stats), _np_tree(jm._state.aux_params)


def _port_model(name):
  _, params, bs, aux = _jax_model(name)
  tm = _build(name, TRV, T, device="cpu")
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, bs))
  if aux is not None:
    tm.aux.load_state_dict(convert.jax_to_torch(tm.aux, aux))
  return tm


def _draw(q, key, sample_shape=()):
  """The standard draws of a JAX latent's ``sample(key)`` as the port's
  ``eps``: a tensor, or (component indices, component noise)."""
  lead = tuple(sample_shape)
  if isinstance(q, JD.MixtureSameFamily):
    kc, ks = jax.random.split(key)
    k = jax.random.categorical(kc, q.mixture_logits, axis=-1,
                               shape=lead + tuple(q.batch_shape))
    c = q.components
    eps = jax.random.normal(ks, lead + tuple(c.batch_shape)
                            + tuple(c.event_shape))
    return torch.tensor(np.asarray(k)), torch.tensor(np.asarray(eps))
  shape = lead + tuple(q.batch_shape) + tuple(q.event_shape)
  return torch.tensor(np.asarray(jax.random.normal(key, shape)))


def _replayed_noise(jm, variables, x, rngs, latents):
  """The draws of one JAX module application with ``rngs``."""
  skey = jm.module.apply(variables, x, rngs=rngs,
                         method=lambda m, *a, **k: m.make_rng("sample"))
  keys = jax.random.split(skey, len(latents))
  return [_draw(q, k) for q, k in zip(latents, keys)]


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
def _jax_side(name):
  jm, params, bs, aux = _jax_model(name)
  batch = _jax_batch(_batch(name))
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  auxj = None if aux is None else jax.tree_util.tree_map(jnp.asarray, aux)
  (loss, (metrics, _, out)), grads = jax.value_and_grad(
      lambda p: jm._loss(p, bs, batch, key, 1.0, training=True,
                         aux_params=auxj), has_aux=True)(pj)
  k1, k2 = jax.random.split(key)
  noise = _replayed_noise(jm, {"params": pj, "batch_stats": bs},
                          batch["inputs"][0], {"sample": k1, "dropout": k2},
                          out.latents)
  return dict(loss=float(loss), metrics=jax.device_get(metrics), out=out,
              grads=jax.device_get(grads), noise=noise)


def _run_port(name, mode, noise):
  tm = _port_model(name)
  old = os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD")
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    loss, metrics, out = tm._loss(_torch_batch(_batch(name)), True, 1.0,
                                  noise=noise)
    loss.backward()
  finally:
    if old is None:
      os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD")
    else:
      os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = old
  return dict(loss=float(loss.detach()), metrics=metrics, out=out,
              grads=_port_grad_tree(tm.module), model=tm)


# ------------------------------------------------------------ distributions
@pytest.mark.parametrize("d", [1, 3, 6])
def test_tril_packing_matches_jax(d):
  """Packed entries land where ``jnp.tril_indices`` puts them, the upper
  triangle stays 0, the diagonal is softplus + 1e-4; the parameter counts
  of 'tril' and 'mixtril' are the JAX ones."""
  flat = np.random.default_rng(d).normal(0, 2, (4, 3, d * (d + 1) // 2))
  flat = flat.astype(np.float32)
  j = np.asarray(jrv._fill_tril(jnp.asarray(flat), d))
  t = trv._fill_tril(torch.tensor(flat), d).numpy()
  off = ~np.eye(d, dtype=bool)
  np.testing.assert_array_equal(t[..., off], j[..., off])
  np.testing.assert_allclose(np.diagonal(t, 0, -2, -1),
                             np.diagonal(j, 0, -2, -1), rtol=1e-6)
  assert trv._tril_size(d) == jrv._tril_size(d)
  for post, kw in (("tril", {}), ("mvntril", {}),
                   ("mixtril", {"n_components": 3})):
    assert (TRV(d, post, kwargs=kw).n_params
            == JRV(d, post, kwargs=kw).n_params)


DISTS = {"tril": {}, "mixtril": {"n_components": 3},
         "mixgaus": {"n_components": 4}}


@pytest.mark.parametrize("sample_shape", [(), (2,)], ids=["one", "mc2"])
@pytest.mark.parametrize("posterior", list(DISTS))
def test_latent_distribution_matches_jax(posterior, sample_shape):
  """log_prob, mean, variance and ``rsample`` at the JAX sample's own
  draws (rtol 1e-5), from the same raw head output."""
  d, n = 4, 7
  kw = DISTS[posterior]
  rv_j, rv_t = JRV(d, posterior, kwargs=kw), TRV(d, posterior, kwargs=kw)
  raw = np.random.default_rng(11).normal(0, 1, (n, rv_j.n_params))
  raw = raw.astype(np.float32)
  qj = rv_j.create_distribution(jnp.asarray(raw))
  qt = rv_t.create_distribution(torch.tensor(raw))
  close = functools.partial(np.testing.assert_allclose, rtol=1e-5,
                            atol=1e-6)
  key = jax.random.key(4, impl="rbg")
  zj = qj.sample(key, sample_shape)
  zt = qt.rsample(sample_shape, eps=_draw(qj, key, sample_shape))
  close(zt.numpy(), np.asarray(zj))
  # the JAX triangular solve takes no extra leading (MC) dims: one per draw
  jlp = (np.stack([np.asarray(qj.log_prob(zs)) for zs in zj]) if sample_shape
         else np.asarray(qj.log_prob(zj)))
  close(qt.log_prob(zt).numpy(), jlp)
  close(qt.mean().numpy(), np.asarray(qj.mean()))
  close(qt.variance().numpy(), np.asarray(qj.variance()))
  x = np.random.default_rng(12).normal(0, 2, (n, d)).astype(np.float32)
  close(qt.log_prob(torch.tensor(x)).numpy(),
        np.asarray(qj.log_prob(jnp.asarray(x))))


def test_mixture_rsample_gradient_reaches_the_picked_component():
  """The draw's gradient reaches the picked component's loc and scale and
  not the mixture logits; ``sample`` draws the same values without a
  gradient, in the same order from the generator."""
  logits = torch.zeros(3, 4, requires_grad=True)
  loc = torch.randn(3, 4, 2, requires_grad=True)
  scale = torch.ones(3, 4, 2, requires_grad=True)
  q = D.MixtureSameFamily(logits, D.Independent(D.Normal(loc, scale), 1))
  k = torch.tensor([0, 3, 1])
  z = q.rsample(eps=(k, torch.randn(3, 4, 2)))
  z.sum().backward()
  assert logits.grad is None or not logits.grad.any()
  picked = torch.zeros(3, 4, dtype=torch.bool)
  picked[torch.arange(3), k] = True
  assert (loc.grad.abs().sum(-1) > 0).eq(picked).all()
  assert (scale.grad.abs().sum(-1) > 0).eq(picked).all()
  a = q.rsample((5,), generator=torch.Generator().manual_seed(1))
  b = q.sample((5,), generator=torch.Generator().manual_seed(1))
  assert torch.equal(a.detach(), b) and not b.requires_grad
  with pytest.raises(ValueError, match="component indices"):
    q.rsample((2,), eps=(k, torch.randn(2, 3, 4, 2)))


# ----------------------------------------------------------- model parity
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
  """Output means, latent means and latent draws, train mode, same draws."""
  j = _jax_side(name)
  t = _run_port(name, "off", j["noise"])
  close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                            atol=1e-5)
  for jp, tp in zip(j["out"].outputs, t["out"].outputs):
    close(tp.mean().detach().numpy(), np.asarray(jp.mean()))
  for jq, tq in zip(j["out"].latents, t["out"].latents):
    assert type(tq).__name__ == type(jq).__name__
    close(tq.mean().detach().numpy(), np.asarray(jq.mean()))
  for jz, tz_ in zip(j["out"].latent_samples, t["out"].latent_samples):
    close(tz_.detach().numpy(), np.asarray(jz))


@pytest.mark.parametrize("mode", ["off", "on"],
                         ids=["dist_math", "fused_op"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name, mode):
  """Loss and metrics rtol 1e-4; every parameter gradient rtol 1e-4 with
  an atol of 1e-4·(largest |gradient| of the model), the rule of
  test_torch_port_models.py. FactorVAE's loss holds γ·TC at the converted
  discriminator, whose parameters get no gradient from it."""
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
  tm = t["model"]
  if name in FVAES:
    assert "tc" in t["metrics"]
    assert all(p.grad is None for p in tm.aux.parameters())
  else:
    assert tm.aux is None and "tc" not in t["metrics"]


def _permutations(z, z_perm):
  """(D, B) indices with z_perm[:, i] == z[perm[i], i]."""
  perms = []
  for i in range(z.shape[1]):
    order = np.argsort(z[:, i])
    perms.append(order[np.searchsorted(z[order, i], z_perm[:, i])])
  perms = np.stack(perms)
  np.testing.assert_array_equal(np.take_along_axis(z, perms.T, 0), z_perm)
  return torch.tensor(perms)


@pytest.mark.parametrize("name", FVAES)
def test_discriminator_update_matches_jax(name):
  """One discriminator step from the same state: the JAX ``_aux_step``'s
  latents (eval mode, the fold_in key) and permutations fed to the port;
  ``disc_loss`` and the aux parameters after one Adam step, rtol 1e-5;
  the main parameters and batch stats untouched."""
  jm, params, bs, aux = _jax_model(name)
  b = _batch(name, seed=5)
  batch = _jax_batch(b)
  tx = optax.adam(jm._disc_lr)
  jm._aux_tx = tx
  auxj = jax.tree_util.tree_map(jnp.asarray, aux)
  state = jm._state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                            batch_stats=bs, aux_params=auxj,
                            aux_opt_state=tx.init(auxj))
  key = jax.random.key(9, impl="rbg")
  new_state, jmet = jm._aux_step(state, batch, key, {})
  k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 0xD15C), 3)
  variables = {"params": state.params, "batch_stats": bs}
  out = jm.module.apply(variables, batch["inputs"][0],
                        rngs={"sample": k1, "dropout": k3}, training=False)
  z = np.asarray(out.latent_samples[0])
  perms = _permutations(z, np.asarray(jfvae._permute_dims(
      jnp.asarray(z), k2)))
  noise = _replayed_noise(jm, variables, batch["inputs"][0],
                          {"sample": k1, "dropout": k3}, out.latents)

  tm = _port_model(name)
  before = {k: v.clone() for k, v in tm.module.state_dict().items()}
  tm.aux_optimizer = tm._make_aux_optimizer()
  tmet = tm._aux_step(_torch_batch(b), {}, noise=noise, perms=perms)
  np.testing.assert_allclose(float(tmet["disc_loss"]),
                             float(jmet["disc_loss"]), rtol=1e-5)
  new_aux = convert.torch_to_jax(tm.aux)[0]
  jl = jax.tree_util.tree_leaves_with_path(_np_tree(new_state.aux_params))
  tl = jax.tree_util.tree_leaves_with_path(new_aux)
  assert [p for p, _ in jl] == [p for p, _ in tl]
  for (path, a), (_, c) in zip(jl, tl):
    np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-7,
                               err_msg=jax.tree_util.keystr(path))
  # the step itself (≈ lr per entry), held to 1e-3 of lr
  for (path, a), (_, c), (_, o) in zip(
      jl, tl, jax.tree_util.tree_leaves_with_path(aux)):
    assert np.abs(c - o).max() > 0.5 * jm._disc_lr
    np.testing.assert_allclose(c - o, a - o, rtol=0,
                               atol=1e-3 * jm._disc_lr,
                               err_msg=jax.tree_util.keystr(path))
  assert all(torch.equal(v, before[k])
             for k, v in tm.module.state_dict().items())


def test_permute_dims_takes_each_column_s_own_permutation():
  z = torch.arange(12.0).reshape(4, 3)
  perms = torch.tensor([[3, 2, 1, 0], [0, 1, 2, 3], [1, 0, 3, 2]])
  np.testing.assert_array_equal(
      tfvae._permute_dims(z, perms=perms).numpy(),
      [[9, 1, 5], [6, 4, 2], [3, 7, 11], [0, 10, 8]])
  drawn = tfvae._permute_dims(z, torch.Generator().manual_seed(0))
  for i in range(3):  # a permutation of each column
    assert sorted(drawn[:, i].tolist()) == z[:, i].tolist()


@pytest.mark.parametrize("name", ["ldvae_single", "ldvae_full"])
def test_ldvae_loadings_and_identity_decoder(name):
  """The decoder holds no parameter in either package, its width is z's,
  and ``get_loadings`` equals the JAX one (atol 1e-6)."""
  jm, params, _, _ = _jax_model(name)
  tm = _port_model(name)
  assert not any(k.startswith("decoder") for k in params)
  assert not any(k.startswith("decoder") for k in tm.module.state_dict())
  assert tm.module.decoders[0].out_dim == LAT["dim"]
  jm._state = jm._state.replace(params=params)
  np.testing.assert_allclose(tm.get_loadings(), jm.get_loadings(),
                             atol=1e-6)
  assert tm.get_loadings().shape == (G, LAT["dim"])
  assert tm.decoder == (NetConf(units=(), name="decoder_identity"),)
  assert tm.module.dispersion == name.split("_")[1]


def test_identity_mlp_keeps_input_dropout():
  """``NetConf(units=())``: no parameters, out_dim = input width, the
  input dropout still drawn in train mode and off in eval mode."""
  mlp = NetConf(units=(), input_dropout=0.5).build(7)
  assert mlp.out_dim == 7 and not list(mlp.parameters())
  assert convert.torch_to_jax(mlp) == ({}, {})
  x = torch.ones(64, 7)
  mlp.eval()
  assert torch.equal(mlp(x), x)
  mlp.train()
  y = mlp(x, torch.Generator().manual_seed(0))
  assert set(torch.unique(y).tolist()) == {0.0, 2.0}


def test_zoo_resolves_and_tril_latents_build():
  for cls in ("SCALE", "SCALAR", "FVAE", "SemiFVAE", "LDVAE"):
    assert T.get_model(cls) is getattr(T, cls)
  assert T.get_model("sfvae") is T.SemiFVAE
  assert T.get_model("ldvae") is T.LDVAE
  assert isinstance(TRV(3, "tril").create_distribution(torch.zeros(2, 9)),
                    D.MultivariateNormalTriL)
  assert isinstance(TRV(3, "mixtril").create_distribution(
      torch.zeros(2, 2 * 10)), D.MixtureSameFamily)
  assert TRV(3, "nzmse").is_deterministic  # scScope's head, ported
  with pytest.raises(ValueError, match="≥2 outputs"):
    T.SCALAR(TRV(G, "zinb", name="rna"), device="cpu")
  with pytest.raises(ValueError, match="≥2 outputs"):
    T.SemiFVAE(TRV(G, "zinb", name="rna"), device="cpu")
  m = T.SCALE(TRV(G, "zinb", name="rna"), device="cpu", analytic=True)
  assert not m.analytic and m.latents[0].kw["n_components"] == 10
  assert m.latents[0].posterior == "mixgaus"


# ----------------------------------------------------------------- fitting
FITS = ["scale", "scalar", "fvae", "semifvae", "ldvae_single"]


@pytest.mark.parametrize("name", FITS)
def test_zoo_fit_with_valid_on_cpu(name):
  """``fit(train, valid=…)``: finite, falling loss, the validation keys,
  FactorVAE's ``tc`` and ``disc_loss`` in the history; evaluate finite;
  no kernel launched off the card."""
  b = _batch(name, seed=3, n=192)
  data = b["inputs"]
  m = _build(name, TRV, T, device="cpu")
  tz.reset_launches()
  m.fit([a[:160] for a in data], valid=[a[160:] for a in data], epochs=4,
        batch_size=32, learning_rate=3e-3, metrics_interval=2,
        labels_percent=0.5, device_cache=True)
  h = m.history
  assert len(h["loss"]) == 4 and len(h["val_loss"]) == 2
  assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
  assert np.isfinite(h["val_loss"]).all()
  assert ({"tc", "disc_loss"} <= set(h)) == (name in FVAES)
  assert "val_tc" not in h  # evaluation carries no TC
  ev = m.evaluate([a[160:] for a in data], batch_size=24)
  assert np.isfinite(list(ev.values())).all()
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}


def test_fvae_rollback_restores_the_discriminator():
  """Early stopping rolls the discriminator and its Adam state back to the
  best epoch, with the main parameters: validation losses 5, 4, 6, 7 and
  patience 2 keep epoch 1's state."""
  m = _build("fvae", TRV, T, device="cpu")
  x = _batch("fvae", seed=4, n=64)["inputs"][0]
  seen, vals = [], iter([5.0, 4.0, 6.0, 7.0])

  def scripted(*a, **k):
    seen.append((copy.deepcopy(m.aux.state_dict()),
                 copy.deepcopy(m.aux_optimizer.state_dict()),
                 copy.deepcopy(m.module.state_dict())))
    return {"loss": next(vals)}
  m._evaluate = scripted
  m.fit(x, valid=x, epochs=4, batch_size=16, patience=2, device_cache=True)
  assert len(m.history["loss"]) == 4 and m.step == 2 * 4
  aux, opt, module = seen[1]
  assert all(torch.equal(v, aux[k]) for k, v in m.aux.state_dict().items())
  assert all(torch.equal(v, module[k])
             for k, v in m.module.state_dict().items())
  got = m.aux_optimizer.state_dict()["state"]
  assert got.keys() == opt["state"].keys()
  for i, s in got.items():
    for k, v in s.items():
      assert torch.equal(v, opt["state"][i][k]), (i, k)
  assert not all(torch.equal(v, seen[3][0][k])
                 for k, v in m.aux.state_dict().items())

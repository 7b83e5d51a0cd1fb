"""Mixed precision in the port against the JAX package.

* The fused ZINB/NB op's bf16 modes: the port's plain version (what its
  CUDA kernels compute) against ``zinb_pallas.zinb_log_prob_rowsum`` on
  bf16 operands. The forward is held against the Pallas kernel itself, run
  in interpret mode (the XLA path's forward rounds intermediates to bf16 on
  the CPU, ~1e-3 off the kernel's f32 math); the backward against both the
  interpreted kernel and the custom VJP's XLA path (``_zinb_grads_elem`` +
  ``astype(primal dtype)``), which agree. Gradients come back in the
  primal's dtype and within 1 bf16 ulp.
* The objective's bf16-operand route (``SISUA_TPU_FWD_OPERANDS=bf16``) at
  a batch JAX casts (B = 32) and one it does not (B = 24).
* ``compute_dtype='bfloat16'``: ``MLP`` (BatchNorm in train and eval) and
  ``DistributionDense`` against flax at converted weights, one train step
  of VAE, SCVI, SISUA and MULTIVI, float32 parameters and predictions,
  and a JAX bf16 checkpoint round trip.
* ``use_conv``: the conv stack against flax in float32 at odd and even
  widths and kernel sizes 3 and 5, and a JAX checkpoint round trip.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.models as J
import sisua_tpu.nn as JN
from sisua_tpu import dist as JD
from sisua_tpu.models import objective as jobj
from sisua_tpu.ops import zinb_pallas as zp
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch import nn as TN
from sisua_tpu_torch.models import objective as tobj
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, R = 40, 5, 48
BF16 = torch.bfloat16
# 2 bf16 ulps of the JAX output's magnitude (2 · 2^-7)
MIXED_RTOL = 1.6e-2


@pytest.fixture
def pallas_interpret(monkeypatch):
  """The JAX package's Pallas kernels, run by the Pallas interpreter on
  the CPU (``pallas_available`` answers True)."""
  from jax.experimental import pallas as pl
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(pl.pallas_call, interpret=True))
  monkeypatch.setattr(zp, "pallas_available", lambda: True)


def _bf16_np(t):
  return np.asarray(jnp.asarray(t).astype(jnp.float32)) \
      if not isinstance(t, torch.Tensor) else t.float().numpy()


def _assert_within_ulp(a, b, ulps=1, what=""):
  """bf16 values (as float32 arrays) within ``ulps`` ulps of the larger."""
  m = np.maximum(np.abs(a), np.abs(b))
  ulp = np.where(m > 0, np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0)))
                                - 7.0), 0.0)
  bad = np.abs(a - b) > ulps * ulp
  assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond {ulps} "
                         f"ulp, worst {np.abs(a - b)[bad].max()}")


def _operands(constrained, layout, B=16, D=G, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.3, 1.0, (B, D))))
       * (rng.uniform(size=(B, D)) > 0.4)).astype(np.float32)
  shapes = [(1 if pg else B, D) for pg in layout]
  cr = rng.normal(0, 1, shapes[0]).astype(np.float32)
  if constrained:
    cr = np.exp(0.5 + 0.7 * cr).astype(np.float32)
  lg = (rng.normal(0, 1, shapes[1]) - 1.0).astype(np.float32)
  gt = (rng.normal(0, 1, shapes[2]) - 1.0).astype(np.float32)
  ct = rng.normal(0, 1, B).astype(np.float32)
  return x, cr, lg, gt, ct


LAYOUTS = {"full": (False, False, False), "gene_theta": (True, False, False),
           "nb_gate": (False, False, True)}


def _cast(a, per_gene):
  """JAX operand: a (B, D) field as bf16, a per-gene row as float32."""
  return jnp.asarray(a) if per_gene else jnp.asarray(a).astype(jnp.bfloat16)


def _jax_fused(x, ops, ct, constrained, nb):
  def f(*p):
    if nb:
      out = zp.nb_log_prob_rowsum(x, p[0], p[1], constrained=constrained)
    else:
      out = zp.zinb_log_prob_rowsum(x, *p, constrained=constrained)
    return jnp.vdot(out, ct), out
  (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(len(ops))),
                                       has_aux=True)(*ops)
  return np.asarray(out), grads


def _port_fused(x, ops, ct, constrained, nb):
  ts = [torch.tensor(np.asarray(jnp.asarray(o).astype(jnp.float32)))
        .to(BF16 if o.dtype == jnp.bfloat16 else torch.float32)
        .requires_grad_() for o in ops]
  tx = torch.tensor(np.asarray(x))
  if nb:
    out = tz.nb_log_prob_rowsum(tx, ts[0], ts[1], constrained=constrained)
  else:
    out = tz.zinb_log_prob_rowsum(tx, *ts, constrained=constrained)
  (out * torch.tensor(np.asarray(ct))).sum().backward()
  return out.detach().numpy(), [t.grad for t in ts]


def _compare_grads(tg, jgs, per_gene, what):
  for i, (t, pg) in enumerate(zip(tg, per_gene)):
    for name, j in jgs.items():
      j = j[i]
      assert str(t.dtype).split(".")[-1] == str(j.dtype), (what, name, i)
      if pg:  # a per-gene float32 sum over the rows
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{what} {name} {i}")
      else:
        _assert_within_ulp(t.float().numpy(), _bf16_np(j),
                           what=f"{what} {name} operand {i}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_fused_bf16_operands_match_pallas(constrained, layout,
                                          pallas_interpret, monkeypatch):
  """bf16 (B, D) operands, float32 per-gene rows: forward rtol 1e-5 against
  the interpreted Pallas kernel; gradients in the primal's dtype, within 1
  bf16 ulp of the kernel's and of the XLA path's."""
  monkeypatch.setenv("SISUA_TPU_BWD_WRITES", "f32")
  per_gene = LAYOUTS[layout]
  nb = layout == "nb_gate"
  x, cr, lg, gt, ct = _operands(constrained, per_gene)
  ops = [_cast(a, pg) for a, pg in zip((cr, lg, gt), per_gene)][:2 if nb
                                                                 else 3]
  out_k, g_k = _jax_fused(jnp.asarray(x), ops, jnp.asarray(ct),
                          constrained, nb)
  with monkeypatch.context() as m:
    m.setattr(zp, "pallas_available", lambda: False)
    _, g_xla = _jax_fused(jnp.asarray(x), ops, jnp.asarray(ct), constrained,
                          nb)
  out_t, g_t = _port_fused(x, ops, ct, constrained, nb)
  np.testing.assert_allclose(out_t, out_k, rtol=1e-5)
  _compare_grads(g_t, {"kernel": g_k, "xla": g_xla}, per_gene, layout)


def test_fused_f32_operands_with_bf16_writes(pallas_interpret, monkeypatch):
  """``SISUA_TPU_BWD_WRITES=bf16`` with float32 operands: the (B, D) fields
  are rounded to bf16 and come back float32, as the Pallas backward's
  bf16 writes cast to the primal dtype; the per-gene θ row stays an f32
  sum. Without the variable the port writes float32 (its default)."""
  per_gene = LAYOUTS["gene_theta"]
  x, cr, lg, gt, ct = _operands(False, per_gene, seed=3)
  ops = [jnp.asarray(a) for a in (cr, lg, gt)]
  monkeypatch.setenv("SISUA_TPU_BWD_WRITES", "bf16")
  _, g_k = _jax_fused(jnp.asarray(x), ops, jnp.asarray(ct), False, False)
  _, g_t = _port_fused(x, ops, ct, False, False)
  for i, (t, j) in enumerate(zip(g_t, g_k)):
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    if per_gene[i]:
      np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                 atol=1e-5)
    else:
      assert torch.equal(t, t.to(BF16).float())  # bf16 values
      _assert_within_ulp(t.numpy(), np.asarray(j), what=f"operand {i}")
  monkeypatch.delenv("SISUA_TPU_BWD_WRITES")
  _, g_f32 = _port_fused(x, ops, ct, False, False)
  assert not torch.equal(g_f32[1], g_f32[1].to(BF16).float())


@pytest.mark.parametrize("rows", [32, 24], ids=["cast", "not_cast"])
def test_objective_bf16_operand_route(rows, pallas_interpret, monkeypatch):
  """``SISUA_TPU_FUSED_LIKELIHOOD=on`` + ``SISUA_TPU_FWD_OPERANDS=bf16`` on
  SCVI's 'full' head (NegativeBinomialLog, zero-inflated): the port casts
  the three (B, D) fields exactly where JAX does (``bf16_operands_ok``:
  B = 32 yes, 24 no), so the row log-likelihoods and the float32
  parameter gradients agree with the JAX objective's."""
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  monkeypatch.setenv("SISUA_TPU_FWD_OPERANDS", "bf16")
  monkeypatch.setenv("SISUA_TPU_BWD_WRITES", "f32")
  assert tz.bf16_operands_ok(rows) == zp.bf16_operands_ok(rows) \
      == (rows == 32)
  rng = np.random.default_rng(rows)
  x = rng.poisson(1.5, (rows, G)).astype(np.float32)
  leaves = [rng.normal(m, 1, (rows, G)).astype(np.float32)
            for m in (0.3, 0.5, -1.0)]  # log μ, log θ, gate logits
  ct = rng.normal(0, 1, rows).astype(np.float32)

  def jax_f(lm, ld, gl):
    d = JD.Independent(JD.ZeroInflated(
        count_distribution=JD.NegativeBinomialLog(log_loc=lm, log_disp=ld),
        gate_logits=gl), 1)
    out = jobj._fast_log_prob(d, jnp.asarray(x))
    return jnp.vdot(out, jnp.asarray(ct)), out
  (_, jout), jg = jax.value_and_grad(jax_f, argnums=(0, 1, 2), has_aux=True)(
      *map(jnp.asarray, leaves))
  ts = [torch.tensor(a, requires_grad=True) for a in leaves]
  d = TD.Independent(TD.ZeroInflated(
      count_distribution=TD.NegativeBinomialLog(log_loc=ts[0],
                                                log_disp=ts[1]),
      gate_logits=ts[2]), 1)
  out = tobj._fast_log_prob(d, torch.tensor(x))
  (out * torch.tensor(ct)).sum().backward()
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                             rtol=1e-5)
  for t, j in zip(ts, jg):
    assert t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-5)
  # the cast shows: bf16-rounded operands move the value off the f32 one
  monkeypatch.setenv("SISUA_TPU_FWD_OPERANDS", "f32")
  f32 = tobj._fast_log_prob(d, torch.tensor(x)).detach().numpy()
  assert (rows == 32) == (not np.array_equal(f32, out.detach().numpy()))


# ------------------------------------------------------------------ layers
def _flax_mlp(conf, x, seed=0):
  mlp = JN.MLP(conf=conf)
  k = jax.random.key(seed)
  variables = mlp.init({"params": k, "dropout": k}, jnp.asarray(x),
                       training=False)
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  stats = variables.get("batch_stats")
  if stats is not None:  # off the (0, 1) init, so eval mode shows them
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 0.3, a.shape) if a.ndim and
                   float(np.asarray(a).mean()) == 0.0
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, stats))
  return mlp, params, stats


def _port_mlp(conf_kw, in_dim, params, stats):
  tm = TN.MLP(in_dim, TN.NetConf(**conf_kw))
  tm.load_state_dict(convert.jax_to_torch(tm, params, stats))
  return tm


def _run_both(conf_kw, x, training, seed=0):
  mlp, params, stats = _flax_mlp(JN.NetConf(**conf_kw), x, seed)
  variables = {"params": params}
  if stats is not None:
    variables["batch_stats"] = stats
  if training:
    jout, mut = mlp.apply(variables, jnp.asarray(x), training=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(1)})
  else:
    jout, mut = mlp.apply(variables, jnp.asarray(x), training=False), {}
  tm = _port_mlp(conf_kw, x.shape[-1], params, stats)
  tm.train(training)
  tout = tm(torch.tensor(x))
  return jout, tout, mut.get("batch_stats"), tm


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_mlp_matches_flax(training):
  """A bf16 MLP with BatchNorm: bf16 output within 2 bf16 ulps of the JAX
  output's magnitude; the running statistics (float32) move as flax's."""
  x = np.random.default_rng(2).normal(0, 1, (16, 24)).astype(np.float32)
  kw = dict(units=(16, 12), batchnorm=True, compute_dtype="bfloat16",
            activation="gelu")
  jout, tout, jstats, tm = _run_both(kw, x, training)
  assert jout.dtype == jnp.bfloat16 and tout.dtype == BF16
  ref = _bf16_np(jout)
  assert np.abs(tout.detach().float().numpy() - ref).max() \
      <= MIXED_RTOL * np.abs(ref).max()
  for p in tm.parameters():
    assert p.dtype == torch.float32
  if training:
    for i in range(2):
      bn = getattr(tm, f"bn{i}")
      assert bn.running_mean.dtype == torch.float32
      np.testing.assert_allclose(bn.running_mean.numpy(),
                                 np.asarray(jstats[f"bn{i}"]["mean"]),
                                 rtol=1e-2, atol=2e-3)
      np.testing.assert_allclose(bn.running_var.numpy(),
                                 np.asarray(jstats[f"bn{i}"]["var"]),
                                 rtol=1e-2, atol=2e-3)


def test_bf16_distribution_dense_matches_flax():
  """The head's matmul in bf16, its raw parameters cast back to float32
  before the distribution: float32 loc and scale within 2 bf16 ulps of
  the JAX head's magnitude."""
  rng = np.random.default_rng(4)
  h = rng.normal(0, 1, (16, 12)).astype(np.float32)
  jd = JN.DistributionDense(JRV(6, "diag", name="z"), compute_dtype="bfloat16")
  params = jax.tree_util.tree_map(np.asarray, jd.init(
      jax.random.key(0), jnp.asarray(h).astype(jnp.bfloat16))["params"])
  jq = jd.apply({"params": params}, jnp.asarray(h).astype(jnp.bfloat16))
  td = TN.DistributionDense(12, TRV(6, "diag", name="z"),
                            compute_dtype="bfloat16")
  td.load_state_dict(convert.jax_to_torch(td, params))
  tq = td(torch.tensor(h).to(BF16))
  for name in ("loc", "scale_diag"):
    a, b = getattr(tq, name), np.asarray(getattr(jq, name))
    assert a.dtype == torch.float32 and b.dtype == np.float32
    assert np.abs(a.detach().numpy() - b).max() \
        <= MIXED_RTOL * np.abs(b).max(), name


@pytest.mark.parametrize("width,kernel", [(21, 3), (24, 5), (17, 5)])
def test_conv_stack_matches_flax(width, kernel):
  """``use_conv``: stride-2 'SAME' convolutions over the features as a 1-D
  sequence, flattened in flax's (W, C) order, float32, rtol 1e-5: with
  BatchNorm in train mode (dropout 0), and with BatchNorm's running stats
  and an inactive dropout in eval mode."""
  x = np.random.default_rng(width).normal(0, 1, (8, width)).astype(
      np.float32)
  for training, dropout in ((True, 0.0), (False, 0.3)):
    kw = dict(units=(4, 3), batchnorm=True, use_conv=True,
              kernel_size=kernel, dropout=dropout, input_dropout=dropout)
    jout, tout, _, tm = _run_both(kw, x, training, seed=kernel)
    assert tuple(tout.shape) == tuple(jout.shape) == (8, tm.out_dim)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
  assert tuple(tm.conv0.weight.shape) == (4, 1, kernel)


def test_same_padding_is_lax():
  """flax's 'SAME' padding, low side first, as lax computes it."""
  for n in range(1, 12):
    for k in (1, 2, 3, 5):
      ref = jax.lax.padtype_to_pads((n,), (k,), (2,), "SAME")[0]
      assert TN.same_padding(n, k, 2) == tuple(ref)


# ------------------------------------------------------------ model steps
NETS = dict(encoder={"units": [24], "batchnorm": True},
            decoder={"units": [24], "batchnorm": True},
            latents=dict(dim=6, posterior="diag", name="latents"))
MULTI_NETS = dict(encoder=({"units": [24], "batchnorm": True},
                           {"units": [16], "batchnorm": True}),
                  decoder=({"units": [24], "batchnorm": True},
                           {"units": [16], "batchnorm": True}),
                  depth={"units": [8]},
                  latents=dict(dim=6, posterior="diag", name="latents"))
MODELS = {
    "vae": ("VAE", [(G, "zinb", "rna")], NETS),
    "sisua": ("SISUA", [(G, "zinb", "rna"), (P, "nb", "adt")],
              dict(NETS, alpha=10.0)),
    "scvi": ("SCVI", [(G, "zinbd", "rna")],
             dict(NETS, encoder_l={"units": [8], "batchnorm": True})),
    "multivi": ("MULTIVI", [(G, "zinbd", "rna"), (R, "bernoulli", "atac")],
                MULTI_NETS),
}


def _build(name, RV, zoo, **extra):
  cls, outs, kw = MODELS[name]
  rvs = [RV(d, p, name=n) for d, p, n in outs]
  return getattr(zoo, cls)(rvs if len(rvs) > 1 else rvs[0], **kw, **extra)


def _batch(name, n=32, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  x[:, 0] += 1.0
  mask = (rng.uniform(size=n) < 0.5).astype(np.float32)
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(n, logc.mean()), np.full(n, logc.var())],
                 1).astype(np.float32)
  inputs = {"vae": [x], "scvi": [x],
            "sisua": [x, rng.poisson(8.0, (n, P)).astype(np.float32)],
            "multivi": [x, (rng.poisson(1.0, (n, R))
                            * (rng.uniform(size=(n, R)) < 0.3)).astype(
                                np.float32)]}[name]
  return {"inputs": inputs, "mask": mask, "library": lib}


@functools.lru_cache(maxsize=None)
def _weights(name):
  """Random (params, batch_stats) in the JAX module's layout (the init is
  traced for its shapes only)."""
  jm = _build(name, JRV, J)
  x, lib = jm._dummy_batch()
  if name == "multivi":
    x = jnp.zeros((2, G + R), jnp.float32)
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  rng = np.random.default_rng(7)

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


def _jax_step(name, dtype):
  params, stats = _weights(name)
  jm = _build(name, JRV, J, compute_dtype=dtype)
  b = _batch(name)
  batch = {k: ([jnp.asarray(a) for a in v] if k == "inputs"
               else jnp.asarray(v)) for k, v in b.items()}
  key = jax.random.key(3, impl="rbg")
  pj = jax.tree_util.tree_map(jnp.asarray, params)
  (loss, (_, _, out)), grads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, stats, batch, key, 1.0, training=True),
      has_aux=True))(pj)
  k1, k2 = jax.random.split(key)
  skey = jm.module.apply({"params": pj, "batch_stats": stats},
                         jm._module_input(batch["inputs"]),
                         rngs={"sample": k1, "dropout": k2},
                         method=lambda m, *a, **k: m.make_rng("sample"))
  n = jm.n_latents
  noise = [torch.tensor(np.asarray(jax.random.normal(
      k, tuple(q.batch_shape) + tuple(q.event_shape))))
      for q, k in zip(out.latents[:n], jax.random.split(skey, n))]
  return float(loss), jax.device_get(grads), noise


def _port_step(name, dtype, noise):
  params, stats = _weights(name)
  tm = _build(name, TRV, T, compute_dtype=dtype, device="cpu")
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  b = _batch(name)
  batch = {k: ([torch.tensor(a) for a in v] if k == "inputs"
               else torch.tensor(v)) for k, v in b.items()}
  loss, _, _ = tm._loss(batch, True, 1.0, noise=noise)
  loss.backward()
  grads = {k: p.grad for k, p in tm.module.named_parameters()}
  return float(loss.detach()), grads, tm


def _jax_grad_of(tree, key, module):
  node = tree
  for part in convert.flax_param_path(module, key):
    node = node[part]
  g = torch.tensor(np.asarray(node))
  return convert._reversed_axes(g) if g.ndim > 1 else g


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_train_step_matches_jax(name):
  """One train-mode step at ``compute_dtype='bfloat16'``, same weights and
  noise: loss rtol 1e-2; the whole parameter gradient within 5e-2 in
  relative norm of JAX's (0.8–1.6% measured); each parameter's within
  0.15 of its norm plus 5e-2 of the gradient's RMS over its size. The
  per-leaf slack is bf16 rounding noise, which the two frameworks place
  differently (XLA keeps excess precision inside its fusions); the RMS
  floor covers the biases ahead of a BatchNorm, whose true gradient
  vanishes and whose bf16 gradient is noise in both. The bf16 step differs
  from the f32 one; parameters and gradients stay float32."""
  jloss, jgrads, noise = _jax_step(name, "bfloat16")
  tloss, tgrads, tm = _port_step(name, "bfloat16", noise)
  np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
  refs = {k: _jax_grad_of(jgrads, k, tm.module) for k in tgrads}
  flat = lambda d: torch.cat([d[k].reshape(-1) for k in tgrads])  # noqa
  ref_all = flat(refs)
  assert float(torch.linalg.vector_norm(flat(tgrads) - ref_all)) \
      <= 5e-2 * float(torch.linalg.vector_norm(ref_all))
  rms = float(torch.linalg.vector_norm(ref_all)) / ref_all.numel() ** 0.5
  for k, g in tgrads.items():
    assert g.dtype == torch.float32
    err = float(torch.linalg.vector_norm(g - refs[k]))
    assert err <= 0.15 * float(torch.linalg.vector_norm(refs[k])) \
        + 5e-2 * rms * g.numel() ** 0.5, k
  floss, fgrads, _ = _port_step(name, None, noise)
  assert floss != tloss
  assert any(not torch.equal(fgrads[k], tgrads[k]) for k in tgrads)
  assert all(p.dtype == torch.float32 for p in tm.module.parameters())


def test_bf16_fit_predict_and_checkpoint_round_trip(tmp_path):
  """A bf16 SCVI fits with float32 parameters and serves float32 values; a
  JAX bf16 checkpoint loads with its compute dtype and saves back byte for
  byte."""
  b = _batch("scvi", n=64)
  tm = _build("scvi", TRV, T, compute_dtype="bfloat16", device="cpu")
  tm.fit(b["inputs"][0], epochs=2, batch_size=32, device_cache=True)
  assert np.isfinite(tm.history["loss"]).all()
  assert all(p.dtype == torch.float32 for p in tm.module.parameters())
  xm, zm = tm.predict_mean(b["inputs"][0], batch_size=32)
  assert xm[0].dtype == np.float32 and zm[0].dtype == np.float32
  pX, _ = tm.predict(b["inputs"][0], batch_size=32)
  assert pX.mean().dtype == torch.float32
  params, stats = _weights("scvi")
  jm = _build("scvi", JRV, J, compute_dtype="bfloat16")
  jm._state = TrainState(step=jnp.zeros((), jnp.int32),
                         params=jax.tree_util.tree_map(jnp.asarray, params),
                         batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                            stats),
                         opt_state=None)
  jm.save_weights(str(tmp_path / "jax"))
  loaded = T.load_model(str(tmp_path / "jax"), device="cpu")
  assert loaded.compute_dtype == "bfloat16"
  assert loaded.encoder[0].compute_dtype == "bfloat16"
  assert loaded.module.MeanScale.compute_dtype == BF16
  loaded.save_weights(str(tmp_path / "port"))
  for f in ("params.msgpack", "batch_stats.msgpack"):
    assert (tmp_path / "jax" / f).read_bytes() \
        == (tmp_path / "port" / f).read_bytes(), f

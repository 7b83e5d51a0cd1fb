"""The probe kernels' plain versions (``sisua_tpu_torch/ops/probe.py``)
against the JAX package's Pallas probes (``benchmarks/kernel_probe.py``),
run by the Pallas interpreter on the CPU.

The TPU script is imported by path with its module globals ``B`` and ``D``
set small (B = 16, D = 300: not a multiple of 128, so the column mask of
the last tile is exercised); ``pl.pallas_call`` is patched to
``interpret=True``. Tolerances: row sums rtol 1e-5 with an atol of 1e-6 of
the row's Σ|element| (the two sum 300 terms in another order and, for the
FMA chain, round 3 steps a little apart); the lgamma forms against
``scipy.special.gammaln`` at rtol 4e-6 (both are ~2e-6 forms, the JAX
docstrings' figure); ``lgammaf``'s plain version is ``torch.lgamma``.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from sisua_tpu_torch.ops import probe as P
from torch_port_threads import _one_thread  # noqa: F401


B, D = 16, 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def kp(monkeypatch):
  """``benchmarks/kernel_probe.py`` at B × D, its kernels interpreted."""
  from jax.experimental import pallas as pl
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(pl.pallas_call, interpret=True))
  spec = importlib.util.spec_from_file_location(
      "kernel_probe_for_test", os.path.join(ROOT, "benchmarks",
                                            "kernel_probe.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  mod.B, mod.D = B, D
  return mod


def _operands(seed=0, contractive=False):
  """The probe's operands (x Poisson(2), θ = exp(0.5·N), logits N, gate
  N − 2) made with numpy; ``contractive`` draws a in (0, 1) so that a long
  FMA chain stays finite."""
  rng = np.random.default_rng(seed)
  x = rng.poisson(2.0, (B, D)).astype(np.float32)
  a = (rng.uniform(0.05, 0.95, (B, D)) if contractive
       else np.exp(0.5 * rng.normal(size=(B, D)))).astype(np.float32)
  b = rng.normal(size=(B, D)).astype(np.float32)
  c = (rng.normal(size=(B, D)) - 2.0).astype(np.float32)
  return x, a, b, c


def _close(port, ref, elems):
  atol = 1e-6 * np.abs(elems).sum(-1)
  err = np.abs(port - ref)
  assert np.all(err <= atol + 1e-5 * np.abs(ref)), (err, ref)


@pytest.mark.parametrize("n_fma", [1, 3, 64])
def test_elemwise_probe_matches_pallas(kp, n_fma):
  ops = _operands(contractive=n_fma > 1)
  ref = np.asarray(kp._elemwise_probe_kernel(n_fma)(
      *(jnp.asarray(a) for a in ops)))
  port = P.elemwise_probe_ref(*(torch.tensor(a) for a in ops), n_fma)
  acc = ops[0].astype(np.float64)
  for _ in range(n_fma):
    acc = acc * ops[1] + ops[2]
  _close(port.numpy(), ref, acc)


@pytest.mark.parametrize("which", ["lanczos", "stirling"])
def test_lgamma_probe_matches_pallas(kp, which):
  ops = _operands(seed=1)
  ref = np.asarray(kp._lgamma_probe_kernel(which)(
      *(jnp.asarray(a) for a in ops)))
  port = P.lgamma_probe_ref(*(torch.tensor(a) for a in ops), which)
  _close(port.numpy(), ref, gammaln(ops[0] + ops[1] + 1.0))


@pytest.mark.parametrize("form", [P.lgamma_lanczos, P.lgamma_stirling],
                         ids=["lanczos", "stirling"])
def test_lgamma_forms_match_gammaln(form):
  """Over (1e-6, 1e4], tiny arguments included (the Lanczos series written
  in x keeps lgamma(1e-6) finite)."""
  x = np.concatenate([np.geomspace(1e-6, 1.0, 200),
                      np.linspace(1.0, 1e4, 500)]).astype(np.float32)
  v = form(torch.tensor(x)).double().numpy()
  ref = gammaln(x.astype(np.float64))
  np.testing.assert_allclose(v, ref, rtol=4e-6, atol=4e-6)


def test_lgammaf_variant_is_torch_lgamma():
  ops = [torch.tensor(a) for a in _operands(seed=2)]
  ref = torch.lgamma(ops[0] + ops[1] + 1.0).sum(-1)
  assert torch.equal(P.lgamma_probe(*ops, "lgammaf"), ref)


def test_cpu_tensors_take_the_plain_versions():
  """A CPU tensor runs the plain version and counts no launch; the
  unread-operand fold propagates a NaN in c (and in b for lgamma), as the
  kernels do."""
  P.reset_launches()
  x, a, b, c = (torch.tensor(t) for t in _operands(seed=3))
  assert torch.equal(P.elemwise_probe(x, a, b, c, 1),
                     P.elemwise_probe_ref(x, a, b, c, 1))
  c[4, 7] = float("nan")
  assert torch.isnan(P.elemwise_probe(x, a, b, c, 1)).nonzero().flatten() \
      .tolist() == [4]
  b[9, 0] = float("nan")
  assert sorted(torch.isnan(P.lgamma_probe(x, a, b, c, "stirling"))
                .nonzero().flatten().tolist()) == [4, 9]
  assert P.launches == {"elemwise_probe": 0, "lgamma_probe": 0}


def test_wrappers_refuse_what_the_kernels_lack():
  x, a, b, c = (torch.tensor(t) for t in _operands())
  with pytest.raises(ValueError, match="n_fma"):
    P.elemwise_probe(x, a, b, c, 2)
  with pytest.raises(ValueError, match="which"):
    P.lgamma_probe(x, a, b, c, "digamma")
  meta = [t.to("meta") for t in (x, a, b, c)]
  with pytest.raises(ValueError, match="CUDA tensors"):
    P.elemwise_probe(*meta, 1)


def test_probe_launch_plan_is_the_forwards():
  """The probes take the ZINB forward's grid and copy width for the same
  (B, D) (``ops/zinb.py::_launch_plan``): 1024 × 33,000 on 132 SMs."""
  from sisua_tpu_torch.ops import zinb as tz
  plan = tz._launch_plan(1024, 33_000, [33_000] * 3, [0] * 4, 132)
  assert plan.vec and plan.fwd_chunks * plan.fwd_tiles * 128 >= 33_000

"""The JAX calls the port refused or lacked before (ROADMAP C3, C4, C5),
each held against the JAX call on the same inputs.

  * ``models.objective.route_fused_likelihood(elements, mode=None)``: an
    element count, by position or by name, as in JAX; 'on' and 'off' give
    the JAX answer, 'auto' the port's rule (True exactly when CUDA is
    available for a count, exactly for a CUDA tensor);
  * the namespace test's walk covers every module file of ``sisua_tpu``;
  * ``ops.sparse.int16_exact`` on edge values, ``ops.sparse.make_densify``
    on a CSR block bitwise equal to the JAX densify, and
    ``native.get_lib`` / ``native.native_available``;
  * the count families' ``sample`` (C5, which the port's notebook met):
    the moments of the JAX draws.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sisua_tpu.models.objective as jobj
import sisua_tpu.native as jnative
import sisua_tpu.ops.sparse as jsparse
import sisua_tpu_torch.models.objective as tobj
import sisua_tpu_torch.native as tnative
import sisua_tpu_torch.ops.sparse as tsparse

from test_torch_port_namespace import MODULES, NOT_MODULES
from torch_port_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("elements", [100, 4_000_000, 40_000_000])
def test_route_takes_an_element_count_as_jax(elements, mode):
  want = jobj.route_fused_likelihood(elements, mode)
  assert tobj.route_fused_likelihood(elements, mode) is want
  assert tobj.route_fused_likelihood(elements=elements, mode=mode) is want


@pytest.mark.parametrize("elements", [100, 4_000_000])
def test_route_auto_follows_the_port_rule(elements, monkeypatch):
  """'auto' (explicit or from the variable) routes a count exactly when
  CUDA is available; the JAX 4M-element gate is a TPU measurement."""
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "auto")
  for cuda in (False, True):
    monkeypatch.setattr(torch.cuda, "is_available", lambda c=cuda: c)
    assert tobj.route_fused_likelihood(elements) is cuda
    assert tobj.route_fused_likelihood(elements=elements,
                                       mode="auto") is cuda
    # a tensor keeps its own rule: a CPU tensor never reaches a kernel
    assert not tobj.route_fused_likelihood(torch.zeros(2, 3))
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  assert tobj.route_fused_likelihood(elements)
  assert jobj.route_fused_likelihood(elements)


def test_the_walk_covers_every_module_file():
  import sisua_tpu
  root = os.path.dirname(sisua_tpu.__file__)
  files = set()
  for d, _, names in os.walk(root):
    for n in names:
      if n.endswith(".py"):
        rel = os.path.relpath(os.path.join(d, n[:-3]), root)
        mod = "sisua_tpu." + rel.replace(os.sep, ".")
        files.add(mod[:-len(".__init__")] if mod.endswith(".__init__")
                  else mod)
  files.discard("sisua_tpu")
  assert files == set(MODULES)
  assert not NOT_MODULES & set(MODULES)


@pytest.mark.parametrize("values", [
    [0, 1, 32766, -32766], [32767], [-32767], [-32768], [1.5], [np.nan],
    [np.inf], np.zeros((0,)), np.array([[3, 4], [5, 32766]], np.int64),
    np.array([70000], np.int64), np.array([-0.0, 2.0], np.float32)],
    ids=lambda v: repr(np.asarray(v).tolist()))
def test_int16_exact_as_jax(values):
  want = jsparse.int16_exact(np.asarray(values))
  assert tsparse.int16_exact(np.asarray(values)) == want
  assert tsparse.int16_exact(torch.as_tensor(np.asarray(values))) == want


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
def test_make_densify_equals_the_jax_densify(dtype):
  rng = np.random.default_rng(21)
  counts = rng.poisson(0.4, (37, 300)).astype(np.float32)
  m = sp.csr_matrix(counts)
  rows = rng.permutation(37)[:29]
  cap = int(m.getnnz(axis=1)[rows].sum()) + 13   # padding past the rows
  col_dtype = jsparse.col_dtype_for(m.shape[1])
  vals, cols, rowlen = jsparse.csr_row_triplets(
      m.indptr, m.indices, m.data, rows, cap, 32, np.float32, col_dtype)
  jdt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
  want = np.asarray(jsparse.make_densify(32, 300, cap, jdt)(
      vals, cols, rowlen)).astype(np.float32)
  got = tsparse.make_densify(32, 300, cap, dtype)(vals, cols, rowlen)
  assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                       else getattr(torch, dtype))
  np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
  np.testing.assert_array_equal(want[:29], counts[rows])
  with pytest.raises(ValueError):
    tsparse.make_densify(32, 300, cap + 1, dtype)(vals, cols, rowlen)


def test_native_library_reported_as_jax():
  assert tnative.native_available() is jnative.native_available() is True
  lib = tnative.get_lib()
  assert lib is tnative.load("gather") and hasattr(lib, "csr_gather_f32")


def test_native_available_reports_a_failed_build(monkeypatch):
  """A library that does not build: ``native_available`` says so, and the
  gathers raise (no numpy fallback)."""
  def fail(name="gather"):
    raise RuntimeError("g++ failed")
  monkeypatch.setattr(tnative, "load", fail)
  assert tnative.get_lib() is None and not tnative.native_available()
  with pytest.raises(RuntimeError):
    tnative.dense_gather(np.zeros((2, 3), np.float32), [1])


def _families(mod, rng):
  """(name, distribution) of each count family the JAX one samples, from
  the same parameters."""
  r = rng.uniform(0.5, 4.0, (3, 5)).astype(np.float32)
  lg = rng.normal(0, 0.5, (3, 5)).astype(np.float32)
  mu = rng.uniform(0.5, 6.0, (3, 5)).astype(np.float32)
  g = rng.normal(0, 1, (3, 5)).astype(np.float32)
  a = (lambda x: jnp.asarray(x)) if mod.__name__.startswith(
      "sisua_tpu.") else torch.tensor
  return [
      ("nb", mod.NegativeBinomial(a(r), a(lg))),
      ("nb_displog", mod.NegativeBinomialDispLog(a(np.log(mu)), a(r[0]))),
      ("nb_log", mod.NegativeBinomialLog(a(np.log(mu)), a(np.log(r)))),
      ("zinb", mod.ZeroInflated(mod.NegativeBinomial(a(r), a(lg)), a(g))),
      ("poisson", mod.Poisson(a(mu))),
      ("bernoulli", mod.Bernoulli(a(g))),
  ]


def test_count_families_sample_as_jax():
  """Every count family samples (the 'zinb' head's NB in logits form, the
  log-space NBs, Poisson and Bernoulli could not, ROADMAP C5): 40,000
  draws of each have the JAX draws' mean within 3% and variance within
  8% (independent streams), and the family's own mean."""
  import jax
  import sisua_tpu.dist as JD
  import sisua_tpu_torch.dist as TD
  jfam = _families(JD, np.random.default_rng(3))
  tfam = _families(TD, np.random.default_rng(3))
  gen = torch.Generator().manual_seed(0)
  for (name, jd), (_, td) in zip(jfam, tfam):
    t = td.sample((40_000,), generator=gen).numpy()
    j = np.asarray(jd.sample(jax.random.PRNGKey(0), (40_000,)))
    assert t.shape == j.shape == (40_000, 3, 5), name
    assert np.all(t == np.round(t)) and t.min() >= 0, name
    np.testing.assert_allclose(t.mean(0), j.mean(0), rtol=0.03, atol=0.02,
                               err_msg=name)
    np.testing.assert_allclose(t.var(0), j.var(0), rtol=0.08, atol=0.02,
                               err_msg=name)
    np.testing.assert_allclose(t.mean(0), td.mean().numpy(), rtol=0.03,
                               atol=0.02, err_msg=name)

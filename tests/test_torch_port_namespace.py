"""The port's public names and signatures against the JAX package's.

Each port namespace must export every name of its JAX counterpart's
``__all__`` (for the top level, the JAX package's lazy ``dir()``), less
the names written below that cannot be ported, or wait for a ROADMAP
item, each with its reason. Each public class must have the JAX class's
public methods, and each function and method must take the JAX
signature's argument names, less the JAX-only ones written below, each
with its reason.
"""

import importlib
import inspect

import pytest

NOT_PORTED = {
    # flax's TrainState: the port keeps a module, an optimizer and a step
    "sisua_tpu.train": {"TrainState"},
    # Pallas on a TPU; the port's counterpart is ops.zinb.kernels_available
    "sisua_tpu.ops": {"pallas_available"},
    # the JAX profiler and XLA's compilation cache (the port profiles with
    # torch.profiler, ``profile_dir``)
    "sisua_tpu.utils": {"profile_trace", "enable_compilation_cache"},
}

MODULES = ["sisua_tpu.models", "sisua_tpu.interpolation", "sisua_tpu.dist",
           "sisua_tpu.train", "sisua_tpu.nn", "sisua_tpu.rv", "sisua_tpu.ops",
           "sisua_tpu.data", "sisua_tpu.data.const", "sisua_tpu.data.utils",
           "sisua_tpu.data.h5ad", "sisua_tpu.data.loaders",
           "sisua_tpu.data.loaders.tenx", "sisua_tpu.data.sisua_to_scvi",
           "sisua_tpu.train.ensemble",
           "sisua_tpu.models.hyper_params", "sisua_tpu.analysis",
           "sisua_tpu.train.experimenter", "sisua_tpu.train.scoreboard",
           "sisua_tpu.data.synthetic", "sisua_tpu.label_threshold",
           "sisua_tpu.utils", "sisua_tpu.baselines",
           "sisua_tpu.analysis.imputation", "sisua_tpu.analysis.latent",
           "sisua_tpu.analysis.sc_monitor", "sisua_tpu.cross_analyze",
           "sisua_tpu.utils.visualization", "sisua_tpu.utils.plot_utils",
           "sisua_tpu.parallel", "sisua_tpu.parallel.mesh"]

# argument names of the JAX signatures that the port's do not take, each
# with its reason, and where (None: anywhere; else the callables whose
# qualified name holds one of the strings)
JAX_ONLY_ARGS = {
    # a jax.random key: the port draws from a torch.Generator or a seed
    "key": None,
    # flax's train flag: a torch module's train()/eval() mode
    "training": None,
    # flax's module tree and module name
    "parent": None, "name": None,
    # flax variables handed to ``apply``: a torch module holds its own
    "params": None, "batch_stats": None,
    # a flax module field: the port's modules take it through
    # ``set_compute_dtype``, and the models keep their ``compute_dtype``
    "compute_dtype": ("Module", "module_cls"),
    # the JAX encoders take the library and ignore it
    "library": "encode",
    # the JAX Trainer's jitted step functions and flax TrainState: the
    # port's Trainer builds its steps from the model it trains
    "step_core": "Trainer", "eval_fn": "Trainer", "state": "Trainer",
    # the JAX objects take a JAX SingleCellOMIC; the port's take matrices
    # (``data``) and var names, or a container through ``data/adapters``:
    # the posterior, the metric callbacks (``extras``: the protein matrix
    # of the JAX container), the clustering score's label omic (the port's
    # callback reads the labels from its ``data``), and DE's ``groupby``
    # column of the container's obs (the port takes the ``labels``)
    "sco": None, "extras": None,
    "label_omic": "ClusteringScores", "groupby": "differential_expression",
    # LDVAE's loadings as a pandas DataFrame indexed by ``var_names``: the
    # port returns the array in the recorded var order
    "var_names": "get_loadings",
}

# JAX methods the port's classes do not have: flax's ``setup`` and the
# jitted JAX step builders (the port's steps are the model's own
# ``_train_step``)
_JAX_ONLY_METHODS = {"setup", "make_train_step", "make_eval_step",
                     "make_train_step_core"}


def _port_name(module):
  return module.replace("sisua_tpu", "sisua_tpu_torch", 1)


@pytest.mark.parametrize("module", MODULES)
def test_port_exports_the_jax_names(module):
  want = set(importlib.import_module(module).__all__)
  want -= NOT_PORTED.get(module, set())
  port = importlib.import_module(_port_name(module))
  missing = sorted(n for n in want if not hasattr(port, n))
  assert not missing, f"{_port_name(module)} lacks {missing}"
  unlisted = sorted(n for n in want if n not in port.__all__)
  assert not unlisted, f"{_port_name(module)}.__all__ lacks {unlisted}"


def _arg_names(fn):
  """(names, takes **kwargs) of a callable's signature, or None."""
  try:
    sig = inspect.signature(fn)
  except (TypeError, ValueError):
    return None
  kinds = inspect.Parameter
  names = [p.name for p in sig.parameters.values()
           if p.kind not in (kinds.VAR_POSITIONAL, kinds.VAR_KEYWORD)]
  return names, any(p.kind == kinds.VAR_KEYWORD
                    for p in sig.parameters.values())


def _missing_args(where: str, jax_fn, port_fn):
  jax_args, port_args = _arg_names(jax_fn), _arg_names(port_fn)
  if jax_args is None or port_args is None or port_args[1]:
    return []
  out = []
  for a in jax_args[0]:
    if a == "self" or a in port_args[0]:
      continue
    scope = JAX_ONLY_ARGS.get(a, ())
    if scope is None or any(s in where for s in (
        (scope,) if isinstance(scope, str) else scope)):
      continue
    out.append(f"{where}({a}=)")
  return out


def _jax_methods(cls):
  for m in dir(cls):
    if m.startswith("_") and m not in ("__init__", "__call__",
                                       "__getitem__", "__len__"):
      continue
    fn = getattr(cls, m, None)
    # flax's and the standard library's own methods are not the package's
    if callable(fn) and str(getattr(fn, "__module__", "")).startswith(
        "sisua_tpu"):
      yield m, fn


@pytest.mark.parametrize("module", MODULES)
def test_port_takes_the_jax_methods_and_arguments(module):
  """Every public class has the JAX class's methods, and every function
  and method takes the JAX argument names (``JAX_ONLY_ARGS`` apart), the
  figures' included; a torch module's ``forward`` answers flax's
  ``__call__``."""
  import torch
  jm = importlib.import_module(module)
  pm = importlib.import_module(_port_name(module))
  skip = NOT_PORTED.get(module, set())
  faults = []
  for n in jm.__all__:
    jo, po = getattr(jm, n, None), getattr(pm, n, None)
    if n in skip or jo is None or po is None:
      continue
    if not inspect.isclass(jo):
      if callable(jo):
        faults += _missing_args(n, jo, po)
      continue
    for m, jf in _jax_methods(jo):
      if m in _JAX_ONLY_METHODS:
        continue
      pf = getattr(po, m, None)
      if m == "__call__" and isinstance(po, type) and issubclass(
          po, torch.nn.Module):
        pf = po.forward
      if pf is None:
        faults.append(f"{n}.{m} is missing")
        continue
      faults += _missing_args(f"{n}.{m}", jf, pf)
  assert not faults, f"{_port_name(module)}: {sorted(set(faults))}"


def test_top_level_resolves_the_jax_names_lazily():
  """``sisua_tpu_torch.SCVI`` and the rest resolve through the package's
  ``__getattr__`` and are listed by ``dir()``, as in the JAX package."""
  import sisua_tpu
  import sisua_tpu_torch
  want = set(dir(sisua_tpu)) - NOT_PORTED.get("sisua_tpu", set()) - {
      "__version__"}
  missing = sorted(n for n in want if not hasattr(sisua_tpu_torch, n))
  assert not missing, f"sisua_tpu_torch lacks {missing}"
  assert want <= set(dir(sisua_tpu_torch))
  from sisua_tpu_torch.data import DataFeeder
  from sisua_tpu_torch.models import SCVI, get_model, load_model
  from sisua_tpu_torch.train import Trainer, VmapEnsemble
  for name, obj in (("SCVI", SCVI), ("get_model", get_model),
                    ("load_model", load_model), ("Trainer", Trainer),
                    ("DataFeeder", DataFeeder),
                    ("VmapEnsemble", VmapEnsemble)):
    assert getattr(sisua_tpu_torch, name) is obj
  with pytest.raises(AttributeError):
    sisua_tpu_torch.not_a_name  # noqa: B018


def test_schedules_and_distribution_helpers_behave_as_jax():
  """The names C1 added compute what the JAX ones compute."""
  import jax.numpy as jnp
  import numpy as np
  import torch
  import sisua_tpu.dist as JD
  import sisua_tpu.interpolation as JI
  import sisua_tpu_torch.dist as TD
  import sisua_tpu_torch.interpolation as TI
  for name, kw in (("linear", dict(vmin=0.1, vmax=2.0, norm=8.0)),
                   ("exp", dict(norm=5.0, delay_in=2.0)),
                   ("cosine", dict(vmax=3.0, norm=4.0, cyclical=True)),
                   ("cyclical", dict(kind="cosine", norm=4.0, delay_in=1.0))):
    js, ts = getattr(JI, name)(**kw), getattr(TI, name)(**kw)
    for step in range(0, 20, 3):
      np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                 atol=1e-7, err_msg=f"{name} at {step}")
  loc = np.arange(28, dtype=np.float32).reshape(7, 4) / 10
  jp = JD.MultivariateNormalDiag(loc=jnp.asarray(loc),
                                 scale_diag=jnp.ones((7, 4)))
  tp = TD.MultivariateNormalDiag(loc=torch.tensor(loc),
                                 scale_diag=torch.ones(7, 4))
  jc = JD.concat_distributions([jp[0:3], jp[3:7]], axis=0)
  tc = TD.concat_distributions([TD.tree_map(lambda t: t[0:3], tp),
                                TD.tree_map(lambda t: t[3:7], tp)])
  assert tuple(tc.batch_shape) == tuple(jc.batch_shape) == (7,)
  np.testing.assert_array_equal(tc.loc.numpy(), np.asarray(jc.loc))
  ts = TD.stack_distributions([tp, tp], axis=0)
  assert tuple(ts.batch_shape) == (2, 7)
  with pytest.raises(ValueError):
    TD.concat_distributions([tp, TD.Normal(torch.zeros(3), torch.ones(3))])
  p = TD.Normal(torch.tensor(1.0), torch.tensor(0.5))
  q = TD.Normal(torch.tensor(0.0), torch.tensor(1.0))
  mc = TD.mc_kl_divergence(p, q, torch.Generator().manual_seed(0), 200000)
  assert abs(float(mc) - float(TD.kl_divergence(p, q))) < 2e-2

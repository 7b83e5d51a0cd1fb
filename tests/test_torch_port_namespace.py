"""The port's public names against the JAX package's.

Each port namespace must export every name of its JAX counterpart's
``__all__`` (for the top level, the JAX package's lazy ``dir()``), less
the names written below that cannot be ported, or wait for a ROADMAP
item, each with its reason.
"""

import importlib

import pytest

# the JAX data layer's pandas half: the OMIC flag type and its helper (the
# port names omics by strings), the availability table and the dataset
# summary (pandas DataFrames over loaders that download), the AnnData and
# 10x readers and writer (h5py, which the card lacks), the marker tables
# and the t-SNE width the port's analysis does not use
_DATA_LAYER = {
    "OMIC", "get_all_omics", "get_dataset_availability",
    "get_dataset_summary", "AVAILABILITY", "read_h5ad", "write_h5ad",
    "read_10x_mtx", "read_10x_h5", "MARKER_ATAC", "MARKER_GENES",
    "PROTEIN_PAIR_NEGATIVE", "PROTEIN_PAIR_POSITIVE", "TSNE_DIM",
}
# what waits for a plotting layer (the card has no matplotlib; ROADMAP
# A12c): the plots and the monitor callbacks, which only plot.
# ResultsSheet is ported without its figures (the score table only)
_A12C = {
    "plot_imputation", "plot_distance_heatmap",
    "plot_latents_protein_pairs", "plot_latents_binary",
    "SingleCellMonitor", "LearningCurves", "ScatterPlot", "HeatmapPlot"}

NOT_PORTED = {
    # flax's TrainState: the port keeps a module, an optimizer and a step
    "sisua_tpu.train": {"TrainState"},
    # Pallas on a TPU; the port's counterpart is ops.zinb.kernels_available
    "sisua_tpu.ops": {"pallas_available"},
    "sisua_tpu.data": _DATA_LAYER,
    "sisua_tpu.analysis": _A12C,
    "sisua_tpu": {"OMIC", "get_dataset_availability", "MARKER_ATAC",
                  "MARKER_GENES", "PROTEIN_PAIR_NEGATIVE",
                  "PROTEIN_PAIR_POSITIVE"} | {
        # submodules of host-only layers: parallel (ROADMAP A21), utils
        # (the JAX profiler and compilation cache), baselines (sklearn),
        # cross_analyze (it always plots; ROADMAP A12c)
        "parallel", "utils", "baselines", "cross_analyze"},
}

MODULES = ["sisua_tpu.models", "sisua_tpu.interpolation", "sisua_tpu.dist",
           "sisua_tpu.train", "sisua_tpu.nn", "sisua_tpu.rv", "sisua_tpu.ops",
           "sisua_tpu.data", "sisua_tpu.train.ensemble",
           "sisua_tpu.models.hyper_params", "sisua_tpu.analysis",
           "sisua_tpu.train.experimenter", "sisua_tpu.train.scoreboard",
           "sisua_tpu.data.synthetic"]


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


def test_top_level_resolves_the_jax_names_lazily():
  """``sisua_tpu_torch.SCVI`` and the rest resolve through the package's
  ``__getattr__`` and are listed by ``dir()``, as in the JAX package."""
  import sisua_tpu
  import sisua_tpu_torch
  want = set(dir(sisua_tpu)) - NOT_PORTED["sisua_tpu"] - {"__version__"}
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

"""The port's ``VmapEnsemble`` on TotalVI and SCANVI, whose forwards draw
beyond their latents (TotalVI's log β, SCANVI's z₂ of every candidate
label, each a third ``noise`` entry the draw plan learns): one fleet step
against the JAX vmapped train step and against single port steps (the
harness and tolerances of ``test_torch_port_ensemble_zoo.py``), and
``fit_hyper_vmap`` of SCANVI on counts and cell-type labels.
AUTOZI and MULTIVI: ``test_torch_port_ensemble_autozi_multivi.py``.
"""

import numpy as np
import pytest

from sisua_tpu_torch import models as T
from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.rv import RVmeta as TRV
from test_torch_port_ensemble_zoo import (fleet_against_jax,
                                          fleet_against_singles,
                                          numpy_batch)

DRAWS = ["totalvi", "scanvi"]


@pytest.mark.parametrize("name", DRAWS)
def test_fleet_step_matches_jax_vmapped_step(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_jax(name)


@pytest.mark.parametrize("name", DRAWS)
def test_fleet_step_equals_member_steps(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_singles(name)


def _data(name, n=128):
  b = [numpy_batch(name, seed=s) for s in range(n // 16)]
  return [np.concatenate([x["inputs"][i] for x in b])
          for i in range(len(b[0]["inputs"]))]


def test_fit_hyper_vmap_scanvi():
  """Every lr × seed trial of SCANVI, on counts and cell-type labels,
  trains at once; each member is rebuilt with its trial's seed and
  extracts as a standalone model that serves."""
  make = lambda s: T.SCANVI(  # noqa: E731
      [TRV(40, "zinbd", name="rna"), TRV(4, "onehot", name="celltype")],
      seed=s, device="cpu", encoder=NetConf((8,), batchnorm=True),
      decoder=NetConf((8,), batchnorm=True),
      encoder_l=NetConf((8,), batchnorm=True), classifier=NetConf((8,)))
  data = _data("scanvi")
  res = fit_hyper_vmap(make, data, learning_rates=(1e-4, 3e-3),
                       seeds_per_rate=2, epochs=2, batch_size=32)
  ens = res["ensemble"]
  assert [t["config"]["seed"] for t in res["trials"]] == [8, 9, 8, 9]
  assert [m.seed for m in ens.models] == [8, 9, 8, 9]
  losses = [t["loss"] for t in res["trials"]]
  assert np.isfinite(losses).all() and len(set(losses)) == 4
  labels = ens.extract(1).predict_labels(data)
  assert labels.shape == (len(data[0]), 4) and np.isfinite(labels).all()

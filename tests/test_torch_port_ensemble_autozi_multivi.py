"""The port's ``VmapEnsemble`` on AUTOZI (δ's log-gamma pair drawn outside
the transform from each member's own α, β; its implicit gamma gradient
through ``torch.func``) and MULTIVI (its fleet fed one noise entry per
posterior its encoder returns, four, where its forward draws two, (z, l):
repaired): one fleet step against the JAX vmapped train step, with one
learning rate and with one per member, and against single port steps
(the harness and tolerances of ``test_torch_port_ensemble_zoo.py``; δ's
implicit gamma gradients reach its parameters' Adam moments at rtol
2e-3), a MULTIVI fleet's fit, and ``fit_hyper_vmap`` of AUTOZI.
"""

import numpy as np
import pytest
import torch

from sisua_tpu_torch import models as T
from sisua_tpu_torch.models.autozi import (_GammaGrad, _LogGammaDraw,
                                           _stacked_log_gamma_pairs)
from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import VmapEnsemble
from test_torch_port_ensemble_zoo import (build, fleet_against_jax,
                                          fleet_against_singles,
                                          numpy_batch)
from torch_port_threads import _one_thread  # noqa: F401


DRAWS = ["autozi", "multivi"]


@pytest.mark.parametrize("name", DRAWS)
def test_fleet_step_matches_jax_vmapped_step(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_jax(name)


def test_autozi_fleet_with_per_member_rates_matches_jax(monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_jax("autozi", "per_member")


@pytest.mark.parametrize("name", DRAWS)
def test_fleet_step_equals_member_steps(name, monkeypatch):
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  fleet_against_singles(name)


def _data(name, n=128):
  b = [numpy_batch(name, seed=s) for s in range(n // 16)]
  return [np.concatenate([x["inputs"][i] for x in b])
          for i in range(len(b[0]["inputs"]))]


def test_multivi_fleet_trains():
  """MULTIVI's fleet: its forward draws (z, l) from the joint and library
  posteriors, not one entry per posterior its encoder returns (joint,
  library and the two experts), so the plan holds two noise entries and
  the fleet trains, each member to its own finite losses."""
  ens = VmapEnsemble(lambda s: build("multivi", TRV, T, seed=s,
                                     device="cpu"), n_models=2)
  data = _data("multivi")
  ens.fit(data, epochs=2, batch_size=32)
  loss = ens.history["loss"]
  assert loss.shape == (2, 2) and np.isfinite(loss).all()
  assert loss[-1, 0] != loss[-1, 1]
  b = {"inputs": [torch.tensor(a[:32]) for a in data],
       "mask": torch.ones(32), "library": torch.zeros(32, 2)}
  plan = ens._draw_plan(b)
  assert len(plan.noise) == 2 and plan.aux is None
  noise, _ = ens._draws(plan)
  assert [tuple(t.shape) for t in noise] == [(2, 32, 4), (2, 32, 1)]


def test_delta_is_drawn_from_each_member_s_own_posterior():
  """The fleet's δ pair for M members comes from each member's α, β: a
  member with α ≫ β draws log Ga > log Gb, one with β ≫ α the reverse."""
  g = 30
  params = {"log_alpha_delta": torch.tensor([[5.0] * g, [-5.0] * g]),
            "log_beta_delta": torch.tensor([[-5.0] * g, [5.0] * g])}
  la, lb = _stacked_log_gamma_pairs(2, torch.Generator().manual_seed(0),
                                    params)
  assert la.shape == lb.shape == (2, g)
  assert (la[0] > lb[0]).all() and (la[1] < lb[1]).all()


def test_log_gamma_draw_batches_without_a_loop():
  """``vmap(grad(…))`` through δ's draw: the gradient of each member equals
  its own unbatched one, and no op falls back to a loop over members."""
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  a = torch.rand(3, 7) * 2 + 0.2
  log_g = torch.log(torch.rand(3, 7) + 0.1)

  def f(ai, lg):
    return torch.sum(torch.sin(_LogGammaDraw.apply(ai, lg)) * ai)
  try:
    with _no_fallback():
      got = torch.func.vmap(torch.func.grad(f))(a, log_g)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  for i in range(3):
    ai = a[i].clone().requires_grad_(True)
    f(ai, log_g[i]).backward()
    torch.testing.assert_close(got[i], ai.grad, rtol=1e-6, atol=1e-7)
  g = torch.exp(log_g)
  torch.testing.assert_close(
      torch.func.vmap(_GammaGrad.apply)(a, g),
      torch._standard_gamma_grad(a, g))


class _no_fallback:
  """Fails on a ``vmap`` fallback's performance warning."""

  def __enter__(self):
    import warnings
    self._cm = warnings.catch_warnings(record=True)
    self._seen = self._cm.__enter__()
    warnings.simplefilter("always")

  def __exit__(self, *exc):
    self._cm.__exit__(*exc)
    slow = [str(w.message) for w in self._seen
            if "performance drop" in str(w.message)]
    assert not slow, slow


def test_fit_hyper_vmap_autozi():
  """Every lr × seed trial of AUTOZI trains at once, δ drawn per member;
  each member is rebuilt with its trial's seed and extracts as a
  standalone model."""
  make = lambda s: T.AUTOZI(  # noqa: E731
      TRV(40, "zinbd", name="rna"), seed=s, device="cpu",
      encoder=NetConf((8,), batchnorm=True),
      decoder=NetConf((8,), batchnorm=True),
      encoder_l=NetConf((8,), batchnorm=True))
  x = _data("autozi")[0]
  res = fit_hyper_vmap(make, x, learning_rates=(1e-4, 3e-3),
                       seeds_per_rate=2, epochs=2, batch_size=32)
  ens = res["ensemble"]
  assert [t["config"]["seed"] for t in res["trials"]] == [8, 9, 8, 9]
  assert [m.seed for m in ens.models] == [8, 9, 8, 9]
  losses = [t["loss"] for t in res["trials"]]
  assert np.isfinite(losses).all() and len(set(losses)) == 4
  _, qZ = ens.extract(1).predict(x)
  assert np.isfinite(qZ[0].mean().numpy()).all()
  zi = ens.extract(3).get_zi_probabilities()
  assert zi.shape == (40,) and ((zi > 0) & (zi < 1)).all()

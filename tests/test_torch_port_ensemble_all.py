"""``VmapEnsemble`` over every class of ``get_all_models()``: a 2-member,
1-epoch fleet of each trains to finite losses that differ between the
members, and each member extracts as a standalone model that serves.
Then the state the fleet writes back (the discriminator's parameters,
moments and count into FactorVAE's ``aux`` and ``aux_optimizer``, from
which a later single-model ``fit`` carries on), and the JAX package's
FactorVAE fleet fault, pinned: ``sisua_tpu``'s ``VmapEnsemble`` cannot
stack FVAE members (only the template gets a discriminator optimizer
state), where the port trains the same members.
"""

import numpy as np
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.nn import NetConf as JNet
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.ensemble import VmapEnsemble as JaxEnsemble
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.rv import RVmeta as R
from sisua_tpu_torch.train import VmapEnsemble
from torch_port_threads import _one_thread  # noqa: F401


G, N, B = 30, 128, 32


def _data():
  rng = np.random.default_rng(0)
  x = rng.poisson(1.0, (N, G)).astype(np.float32)
  x[:, 0] += 1
  return {"x": x,
          "adt": rng.poisson(5.0, (N, 4)).astype(np.float32),
          "celltype": np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)],
          "atac": (rng.uniform(size=(N, 40)) < 0.2).astype(np.float32)}


DATA = _data()
NETS = dict(device="cpu", encoder=NetConf((8,)), decoder=NetConf((8,)))
RNA, RNAD = R(G, "zinb", name="rna"), R(G, "zinbd", name="rna")
ADT = R(4, "nb", name="adt")
# class name → (constructor of a member from its seed, data names)
CLASSES = {
    "VAE": (lambda s: T.VAE(RNA, seed=s, **NETS), ["x"]),
    "SISUA": (lambda s: T.SISUA([RNA, ADT], seed=s, **NETS), ["x", "adt"]),
    "MISA": (lambda s: T.MISA([RNA, ADT], seed=s, **NETS), ["x", "adt"]),
    "DeepCountAutoencoder": (lambda s: T.DeepCountAutoencoder(
        RNA, seed=s, **NETS), ["x"]),
    "SCVI": (lambda s: T.SCVI(RNAD, seed=s, **NETS), ["x"]),
    "LDVAE": (lambda s: T.LDVAE(R(G, "nbd", name="rna"), seed=s,
                                device="cpu", encoder=NetConf((8,))), ["x"]),
    "SCALE": (lambda s: T.SCALE(RNA, seed=s, **NETS), ["x"]),
    "SCALAR": (lambda s: T.SCALAR([RNA, ADT], seed=s, **NETS), ["x", "adt"]),
    "FVAE": (lambda s: T.FVAE(RNA, seed=s, discriminator_units=(8, 8),
                              **NETS), ["x"]),
    "SemiFVAE": (lambda s: T.SemiFVAE([RNA, ADT], seed=s,
                                      discriminator_units=(8, 8), **NETS),
                 ["x", "adt"]),
    "TotalVI": (lambda s: T.TotalVI([RNAD, ADT], seed=s, **NETS),
                ["x", "adt"]),
    "SCANVI": (lambda s: T.SCANVI([RNAD, R(3, "onehot", name="celltype")],
                                  seed=s, **NETS), ["x", "celltype"]),
    "PEAKVI": (lambda s: T.PEAKVI(R(40, "bernoulli", name="atac"), seed=s,
                                  **NETS), ["atac"]),
    "MULTIVI": (lambda s: T.MULTIVI([RNAD, R(40, "nb", name="atac")],
                                    seed=s, **NETS), ["x", "atac"]),
    "SCScope": (lambda s: T.SCScope(RNAD, seed=s, **NETS), ["x"]),
    "AUTOZI": (lambda s: T.AUTOZI(RNAD, seed=s, **NETS), ["x"]),
}


def test_every_class_is_covered():
  assert sorted(CLASSES) == sorted(c.__name__ for c in T.get_all_models())


@pytest.mark.parametrize("name", list(CLASSES))
def test_fleet_of_every_class_trains_and_serves(name):
  make, names = CLASSES[name]
  data = [DATA[k] for k in names]
  ens = VmapEnsemble(make, n_models=2)
  ens.fit(data if len(data) > 1 else data[0], epochs=1, batch_size=B,
          labels_percent=0.5)
  loss = ens.history["loss"]
  assert loss.shape == (1, 2) and np.isfinite(loss).all()
  assert loss[0, 0] != loss[0, 1]
  for i in range(2):
    m = ens.extract(i)
    assert m.step == N // B
    _, qZ = m.predict(data if len(data) > 1 else data[0], batch_size=64)
    z = (qZ[0] if isinstance(qZ, (tuple, list)) else qZ).mean()
    assert tuple(z.shape[:1]) == (N,) and torch.isfinite(z).all()


def test_fvae_members_carry_their_discriminator_on():
  """After the fleet, each member's ``aux`` holds its own trained
  discriminator and its ``aux_optimizer`` the fleet's Adam moments and
  count; a single-model ``fit`` of an extracted member carries on from
  them (its count goes on from the fleet's)."""
  make, _ = CLASSES["FVAE"]
  fresh = [make(s) for s in range(2)]
  ens = VmapEnsemble(make, n_models=2)
  ens.fit(DATA["x"], epochs=2, batch_size=B)
  st = ens._stacked["aux"]
  steps = 2 * N // B
  assert st["count"].tolist() == [steps, steps]
  for i, m in enumerate(ens.models):
    for k, p in m.aux.named_parameters():
      assert torch.equal(p.detach(), st["params"][k][i])
      assert not torch.equal(p.detach(),
                             dict(fresh[i].aux.named_parameters())[k])
      state = m.aux_optimizer.state[p]
      assert float(state["step"]) == steps
      assert torch.equal(state["exp_avg"], st["mu"][k][i])
      assert torch.equal(state["exp_avg_sq"], st["nu"][k][i])
  member = ens.extract(1)
  member.fit(DATA["x"], epochs=1, batch_size=B, device_cache=True)
  p = next(member.aux.parameters())
  assert float(member.aux_optimizer.state[p]["step"]) == steps + N // B
  assert np.isfinite(member.history["loss"]).all()


def test_jax_ensemble_cannot_stack_fvae_members():
  """The JAX package's fault, left as it is (ROADMAP §C): its
  ``VmapEnsemble`` gives only the template member a discriminator
  optimizer state, and stacking the members meets ``None``. The port's
  fleet of the same members trains."""
  x = DATA["x"]
  jax_fleet = JaxEnsemble(lambda s: J.FVAE(
      JRV(G, "zinb", name="rna"), seed=s, encoder=JNet((8,)),
      decoder=JNet((8,)), discriminator_units=(8, 8)), n_models=2)
  with pytest.raises(ValueError):
    jax_fleet.fit(x, epochs=1, batch_size=B)
  assert jax_fleet.models[0]._state.aux_opt_state is not None
  assert jax_fleet.models[1]._state.aux_opt_state is None
  ens = VmapEnsemble(CLASSES["FVAE"][0], n_models=2)
  ens.fit(x, epochs=1, batch_size=B)
  assert np.isfinite(ens.history["loss"]).all()

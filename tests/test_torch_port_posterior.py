"""The port's posterior hub (``sisua_tpu_torch.analysis.Posterior`` and
``SingleCellModel.create_posterior``) against the JAX package's.

Both hubs get the same test data (the JAX ``SingleCellOMIC`` of
``generate_synthetic`` with proteins and cell types; the port its
matrices as a dict, with the var names beside them) and both models'
``predict`` return distributions built from the same parameter arrays and
latent means, one set for the corrupted data and one for the original.
Then ``save_scores()`` and every criticizer's ``cal_all_scores()`` give
the JAX keys, for an unsupervised VAE and for SISUA, with values within
1e-6, or 1e-5 relative where float32 means and log-likelihoods enter; the
protein F1s (linear SVMs, the port's at their objective's minimum,
liblinear's at its tolerance) within 0.01. ``compute_llk`` through the
fused op (``mc_row_log_prob``, the draws as its member axis) equals the
distribution math at the same draws (rtol 1e-5).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.data import generate_synthetic
from sisua_tpu.rv import RVmeta as JRV
import sisua_tpu_torch.dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models import base as tbase
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401

S, N, G, P, L = 3, 128, 40, 6, 5
RTOL = 1e-5


@pytest.fixture(scope="module")
def sco():
  return generate_synthetic(n_cells=N, n_genes=G, n_proteins=P,
                            n_celltypes=3, seed=3)


def _fields(seed, cols, kind):
  rng = np.random.default_rng(seed)
  f = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)  # noqa
  out = dict(total_count=np.exp(f(S, N, cols)).astype(np.float32),
             logits=f(S, N, cols))
  if kind == "zinb":
    out["gate"] = f(S, N, cols)
  return out


def _dist(pkg, p):
  a = jnp.asarray if pkg is JD else torch.tensor
  count = pkg.NegativeBinomial(a(p["total_count"]), a(p["logits"]))
  if "gate" in p:
    count = pkg.ZeroInflated(count, a(p["gate"]))
  return pkg.Independent(count, 1)


def _latent(pkg, loc):
  a = jnp.asarray if pkg is JD else torch.tensor
  return pkg.MultivariateNormalDiag(loc=a(loc),
                                    scale_diag=a(np.ones_like(loc)))


def _predictions(kinds, sco, seed):
  """(JAX (pX, qZ), port (pX, qZ)) of one prediction source: the latent
  means follow the cell types, so the clusters are there to find."""
  params = [_fields(seed + i, d, k) for i, (d, k) in enumerate(kinds)]
  rng = np.random.default_rng(seed + 10)
  ids = sco.numpy("celltype").argmax(1)
  loc = (rng.normal(size=(N, L)) + 3.0 * np.eye(3, L)[ids]).astype(
      np.float32)

  def one(pkg):
    px = tuple(_dist(pkg, p) for p in params)
    return (px if len(px) > 1 else px[0]), _latent(pkg, loc)
  return one(JD), one(TD)


def _patch_predict(jm, tm, kinds, sco):
  """Both models' ``predict``: the corrupted source first, then the
  original, as the hubs call them."""
  cor, org = _predictions(kinds, sco, 0), _predictions(kinds, sco, 100)
  calls = {"jax": 0, "port": 0}

  def jax_predict(*a, **kw):
    calls["jax"] += 1
    return (cor if calls["jax"] == 1 else org)[0]

  def port_predict(*a, **kw):
    calls["port"] += 1
    return (cor if calls["port"] == 1 else org)[1]
  jm.predict = jax_predict
  tm.predict = port_predict
  return calls


MODELS = {
    "vae": (J.VAE, T.VAE, [(G, "zinb")]),
    "sisua": (J.SISUA, T.SISUA, [(G, "zinb"), (P, "nb")]),
}


def _models(name):
  jcls, tcls, kinds = MODELS[name]
  names = ["transcriptomic", "proteomic"]
  jm = jcls([JRV(d, k, name=n) for (d, k), n in zip(kinds, names)])
  tm = tcls([TRV(d, k, name=n) for (d, k), n in zip(kinds, names)],
            device="cpu")
  return jm, tm, kinds


def _port_data(sco):
  data = {o: np.asarray(sco.numpy(o), np.float32) for o in sco.omics}
  names = {o: list(np.asarray(sco.get_var_names(o), str))
           for o in sco.omics}
  return data, names


def _hubs(name, sco):
  jm, tm, kinds = _models(name)
  calls = _patch_predict(jm, tm, kinds, sco)
  jpost = jm.create_posterior(sco)
  data, names = _port_data(sco)
  tpost = tm.create_posterior(data, var_names=names)
  assert calls == {"jax": 2, "port": 2}
  return jpost, tpost


def _close(got, want, loose=()):
  assert list(got) == list(want)
  for k in want:
    if any(k.startswith(p) for p in loose):
      assert abs(got[k] - want[k]) <= 0.01, k
    else:
      np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-6,
                                 err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_save_scores_match_jax(name, sco):
  jpost, tpost = _hubs(name, sco)
  assert tpost.output_omics == jpost.output_omics
  assert tpost.factor_omics == jpost.factor_omics == ["proteomic",
                                                      "celltype"]
  np.testing.assert_array_equal(tpost.corrupted["transcriptomic"],
                                jpost.sco_corrupted.numpy())
  want, got = jpost.save_scores(), tpost.save_scores()
  assert tpost.failures == {}
  assert any(k.startswith("f1_") for k in want)
  if name == "sisua":
    assert "protein_pearson_mean" in want
  _close(got, want, loose=("f1_",))
  for f in jpost.criticizers:
    _close(tpost.criticizers[f].cal_all_scores(),
           jpost.criticizers[f].cal_all_scores())


def test_hub_surface_matches_jax(sco):
  jpost, tpost = _hubs("sisua", sco)
  assert sorted(tpost.dataset) == sorted(jpost.dataset.omics)
  for omic in ("itranscriptomic", "iproteomic", "proteomic"):
    np.testing.assert_allclose(tpost.get_data(omic),
                               jpost.get_data(omic), rtol=RTOL, atol=1e-6)
  np.testing.assert_array_equal(tpost.dataset["latent"],
                                jpost.dataset.numpy("latent"))
  assert tpost.get_data("latent") is tpost.qZ_cor
  np.testing.assert_array_equal(tpost.get_data("transcriptomic",
                                               "corrupted"),
                                jpost.get_data("transcriptomic",
                                               "corrupted"))
  assert tpost.get_data("latent", "original") is tpost.qZ_org
  with pytest.raises(ValueError):
    tpost.get_data("atac")
  assert tpost.get_marker_pairs() == jpost.get_marker_pairs()
  assert tpost.get_marker_pairs("iproteomic", "itranscriptomic") == \
      jpost.get_marker_pairs("iproteomic", "itranscriptomic")
  for method in ("spearman", "mi", "importance"):
    np.testing.assert_allclose(
        tpost.get_correlation_matrix(method, "celltype"),
        jpost.get_correlation_matrix(method, "celltype"), atol=1e-6)
  # a criticizer of the imputed proteins, made on demand
  for fn in ("cal_mutual_info_gap", "cal_total_correlation",
             "cal_relative_disentanglement_strength"):
    _close(getattr(tpost.get_criticizer("iproteomic"), fn)(),
           getattr(jpost.get_criticizer("iproteomic"), fn)())
  for fn in ("cal_betavae", "cal_factorvae", "cal_importance"):
    _close(getattr(tpost, fn)(), getattr(jpost, fn)())


def _sisua_with_data():
  rng = np.random.default_rng(0)
  x = rng.poisson(2.0, (96, G)).astype(np.float32)
  y = rng.poisson(20.0, (96, P)).astype(np.float32)
  small = dict(encoder={"units": [16]}, decoder={"units": [16]})
  model = T.SISUA([TRV(G, "zinb", name="transcriptomic"),
                   TRV(P, "nb", name="proteomic")], device="cpu", **small)
  return model, x, y


def test_compute_llk_through_the_fused_op_equals_distribution_math(
    monkeypatch):
  model, x, y = _sisua_with_data()
  cor = x.copy()
  cor[:, :5] = 0
  targets = {"dataorg": [x, y], "datacor": [cor, y]}
  reached = []
  fused = tbase.mc_row_log_prob

  def counted(dist, m):
    reached.append(tuple(dist.batch_shape))
    return fused(dist, m)
  state = model.generator.get_state()
  monkeypatch.setattr(tbase, "mc_row_log_prob", counted)
  got = model.compute_llk([cor, y], targets, sample_shape=(S,),
                          batch_size=32)
  assert reached and all(b[0] == S for b in reached)
  model.generator.set_state(state)
  monkeypatch.setattr(tbase, "mc_row_log_prob",
                      lambda dist, m: dist.log_prob(m))
  want = model.compute_llk([cor, y], targets, sample_shape=(S,),
                           batch_size=32)
  assert list(got) == list(want) == ["dataorg_output0", "dataorg_output1",
                                     "datacor_output0", "datacor_output1"]
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_device_cache_llk_and_marginal_llk():
  """``device_cache=True`` scores the 4-way LLK through ``compute_llk``
  with the host path's keys (``mesh=``: tests/test_torch_port_mesh.py;
  a mesh needs a world)."""
  model, x, y = _sisua_with_data()
  data = {"transcriptomic": x, "proteomic": y}
  host = model.create_posterior(data, sample_shape=2).cal_llk()
  dev = model.create_posterior(data, sample_shape=2, device_cache=True)
  llk = dev.cal_llk()
  # the key set of the host path (in the JAX device path's order)
  assert sorted(llk) == sorted(host) and len(llk) == 8
  assert all(math.isfinite(v) for v in llk.values())
  assert dev.cal_llk() is llk  # cached
  m = dev.cal_marginal_llk(sample_shape=4)
  assert list(m) == ["marginal_llk_transcriptomic"]
  assert math.isfinite(m["marginal_llk_transcriptomic"])
  with pytest.raises(RuntimeError, match="process group"):
    from sisua_tpu_torch.parallel import create_mesh
    model.create_posterior(data, mesh=create_mesh())


def test_default_llk_takes_the_fused_op_on_the_predictions(monkeypatch):
  """``device_cache=False``: ``cal_llk`` reduces the distributions that
  ``predict`` returned, a batch at a time on the model's device, through
  the fused op (the draws as its member axis), and equals their
  distribution math (rtol 1e-5)."""
  from sisua_tpu_torch.models import objective
  model, x, y = _sisua_with_data()
  post = model.create_posterior({"transcriptomic": x, "proteomic": y},
                                sample_shape=S, batch_size=32)
  fused, calls = objective._fused, []

  def counted(*a, **kw):
    calls.append(1)
    return fused(*a, **kw)
  monkeypatch.setattr(objective, "_fused", counted)
  got = post.cal_llk()
  # 2 sources × 3 batches × 2 heads × 2 target sets
  assert len(calls) == 2 * 3 * 2 * 2
  want = post._cal_llk_of_predictions(lambda dist, m: dist.log_prob(m))
  assert list(got) == list(want) and len(got) == 8
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)

"""The port's Criticizer, latent-space scores and ``ClusteringScores``
callback (``sisua_tpu_torch.analysis``) against the JAX package's, which
run on sklearn.

* ``discretize_factors`` equal; ``Criticizer.cal_all_scores`` gives the
  JAX key set, with every value within 1e-6 (the same numpy draws pick the
  same DCI, BetaVAE and FactorVAE rows; the boosted trees, KMeans and the
  mixture are sklearn's to rounding, and the BetaVAE classifier's score
  is equal), on count-valued factors (proteins) and on one-hot factors
  (cell types); the three matrices equal.
* The JAX ground-truth cases of ``tests/test_criticizer_ground_truth.py``,
  rebuilt on the port's Criticizer.
* ``clustering_scores``, ``unsupervised_clustering_accuracy``,
  ``multi_label_adj_Rindex`` equal the JAX functions within 1e-10;
  ``streamline_classifier`` gives the JAX keys with F1 within 0.01 (the
  port's SVMs reach liblinear's objective minimum, liblinear stops at its
  tolerance).
* ``ClusteringScores`` in a small fit logs the JAX keys at the JAX epochs.
"""

import numpy as np
import pytest
import torch

import sisua_tpu.analysis as JA
import sisua_tpu_torch.analysis as TA
from sisua_tpu_torch.analysis.criticizer import Criticizer
from torch_port_threads import _one_thread  # noqa: F401


def _latents_factors(kind, n=400, d=6, seed=0):
  rng = np.random.default_rng(seed)
  if kind == "proteins":
    F = rng.poisson(rng.uniform(1, 30, 4), (n, 4)).astype(np.float64)
    Z = np.log1p(F) @ rng.normal(size=(4, d)) + rng.normal(size=(n, d))
  else:
    ids = rng.integers(0, 3, n)
    F = np.eye(3)[ids]
    Z = rng.normal(size=(n, d)) + 2.0 * np.eye(3, d)[ids]
  return Z.astype(np.float32), F


@pytest.mark.parametrize("kind", ["proteins", "celltypes"])
def test_criticizer_all_scores_match_jax(kind):
  Z, F = _latents_factors(kind)
  names = [f"f{i}" for i in range(F.shape[1])]
  want = JA.Criticizer(Z, F, factor_names=names, seed=3)
  got = TA.Criticizer(torch.as_tensor(Z), F, factor_names=names, seed=3,
                      device="cpu")
  np.testing.assert_array_equal(got.factor_codes, want.factor_codes)
  np.testing.assert_array_equal(got.latent_codes, want.latent_codes)
  js, ts = want.cal_all_scores(), got.cal_all_scores()
  assert list(ts) == list(js)
  for k in js:
    np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, atol=1e-6,
                               err_msg=k)
  for method in ("spearman", "pearson"):
    np.testing.assert_allclose(got.create_correlation_matrix(method),
                               want.create_correlation_matrix(method),
                               rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(got.create_mutualinfo_matrix(),
                             want.create_mutualinfo_matrix(), atol=1e-10)
  np.testing.assert_allclose(got.create_importance_matrix()[0],
                             want.create_importance_matrix()[0], atol=1e-6)


def test_discretize_factors_matches_jax():
  rng = np.random.default_rng(1)
  F = np.concatenate([rng.normal(size=(200, 2)),
                      rng.integers(0, 3, (200, 1))], 1)
  np.testing.assert_array_equal(TA.discretize_factors(F, 5),
                                JA.discretize_factors(F, 5))


# ------------------------------------------- the JAX ground-truth cases
N, K, NOISE_DIMS = 4000, 4, 3


def _factors(rng, n=N, k=K, levels=5):
  return rng.integers(0, levels, size=(n, k)).astype(np.float64)


@pytest.fixture(scope="module")
def disentangled():
  """Latents = permuted factor copies + independent noise dims."""
  rng = np.random.default_rng(0)
  F = _factors(rng)
  perm = np.array([2, 0, 3, 1])
  Z = np.concatenate([F[:, perm], rng.normal(size=(N, NOISE_DIMS))], axis=1)
  Z[:, :K] += rng.normal(0, 1e-3, size=(N, K))
  return Criticizer(Z, F, n_bins=5, seed=1, device="cpu")


@pytest.fixture(scope="module")
def entangled():
  """Every latent is the same mixture of all factors (plus jitter)."""
  rng = np.random.default_rng(1)
  F = _factors(rng)
  mix = F.sum(1, keepdims=True)
  Z = np.repeat(mix, 5, axis=1) + rng.normal(0, 1e-3, size=(N, 5))
  return Criticizer(Z, F, n_bins=5, seed=1, device="cpu")


def test_mig_perfect_and_entangled(disentangled, entangled):
  assert disentangled.cal_mutual_info_gap()["mig"] > 0.85
  assert entangled.cal_mutual_info_gap()["mig"] < 0.1


def test_dci_perfect(disentangled):
  s = disentangled.cal_dci_scores()
  assert s["disentanglement"] > 0.85
  assert s["completeness"] > 0.85
  assert s["informativeness"] > 0.95


def test_sap_equals_factor_entropy(disentangled):
  s = disentangled.cal_separated_attr_predictability()["sap"]
  h = []
  for j in range(K):
    _, cnt = np.unique(disentangled.factor_codes[:, j], return_counts=True)
    p = cnt / cnt.sum()
    h.append(-np.sum(p * np.log(p)))
  np.testing.assert_allclose(s, np.mean(h), rtol=0.1)


def test_relative_strengths(disentangled, entangled):
  assert disentangled.cal_relative_disentanglement_strength()["rds"] > 0.8
  assert disentangled.cal_relative_mutual_strength()["rms"] > 0.8
  assert entangled.cal_relative_disentanglement_strength()["rds"] < 0.1
  assert entangled.cal_relative_mutual_strength()["rms"] < 0.1


def test_interventional_scores_perfect(disentangled):
  assert disentangled.cal_betavae_score()["betavae"] > 0.9
  assert disentangled.cal_factorvae_score()["factorvae"] > 0.9


def test_tc_gaussian_analytic_and_independent(disentangled):
  rho = 0.8
  rng = np.random.default_rng(2)
  Z = rng.multivariate_normal([0, 0], [[1.0, rho], [rho, 1.0]],
                              size=200_000)
  F = rng.integers(0, 3, size=(len(Z), 2)).astype(np.float64)
  tc = Criticizer(Z, F, device="cpu").cal_total_correlation()["tc"]
  np.testing.assert_allclose(tc, -0.5 * np.log(1 - rho**2), rtol=0.05)
  assert disentangled.cal_total_correlation()["tc"] < 0.05


def test_mig_monotone_in_noise():
  rng = np.random.default_rng(3)
  F = _factors(rng, n=1000)
  migs = []
  for frac in (0.0, 0.5, 0.95):
    Z = F.copy() + rng.normal(0, 1e-3, F.shape)
    m = rng.random(F.shape) < frac
    Z[m] = rng.integers(0, 5, size=int(m.sum()))
    migs.append(Criticizer(Z, F, seed=1,
                           device="cpu").cal_mutual_info_gap()["mig"])
  assert migs[0] > migs[1] > migs[2]


def test_degenerate_single_factor_and_single_latent():
  rng = np.random.default_rng(4)
  F = rng.integers(0, 4, size=(400, 1)).astype(np.float64)
  Z = np.concatenate([F + rng.normal(0, 0.01, F.shape),
                      rng.normal(size=(400, 2))], axis=1)
  scores = Criticizer(Z, F, seed=1, device="cpu").cal_all_scores()
  assert 0.0 <= scores["disentanglement"] <= 1.0
  assert 0.0 <= scores["completeness"] <= 1.0
  assert 0.0 <= scores["betavae"] <= 1.0  # majority-vote fallback
  F2 = rng.integers(0, 4, size=(400, 2)).astype(np.float64)
  one = Criticizer(F2[:, :1] + rng.normal(0, 0.01, (400, 1)), F2, seed=1,
                   device="cpu")
  assert all(np.isfinite(v) for v in one.cal_all_scores().values())


def test_clustering_scores_cached():
  rng = np.random.default_rng(6)
  F = rng.integers(0, 3, size=(300, 2)).astype(np.float64)
  crit = Criticizer(rng.normal(size=(300, 4)), F, seed=1, device="cpu")
  first = crit.cal_clustering_scores()
  assert crit.cal_clustering_scores() is first


# ------------------------------------------------------ latent-space scores
def test_latent_scores_match_jax():
  rng = np.random.default_rng(7)
  ids = rng.integers(0, 4, 500)
  Z = rng.normal(size=(500, 5)) + 2.5 * np.eye(4, 5)[ids]
  want = JA.clustering_scores(Z, ids, seed=8)
  got = TA.clustering_scores(torch.as_tensor(Z), ids, seed=8, device="cpu")
  assert list(got) == list(want) == ["ASW", "ARI", "NMI", "UCA"]
  for k in want:
    assert abs(got[k] - want[k]) <= 1e-10, k
  for algo in ("kmeans", "gmm"):
    w = JA.clustering_scores(Z, ids, prediction_algorithm=algo)
    g = TA.clustering_scores(Z, ids, prediction_algorithm=algo,
                             device="cpu")
    assert all(abs(g[k] - w[k]) <= 1e-10 for k in w), algo
  pred = rng.integers(0, 5, 500)
  acc, assign = TA.unsupervised_clustering_accuracy(ids, pred)
  jacc, jassign = JA.unsupervised_clustering_accuracy(ids, pred)
  assert acc == jacc
  np.testing.assert_array_equal(assign, jassign)
  bins = (rng.random((500, 3)) < 0.3).astype(int)
  np.testing.assert_allclose(
      TA.multi_label_adj_Rindex(bins, pred, device="cpu"),
      JA.multi_label_adj_Rindex(bins, pred), atol=1e-10)


def test_streamline_classifier_matches_jax():
  rng = np.random.default_rng(8)
  Z = rng.normal(size=(500, 6))
  y = np.stack([Z[:, 0] + 0.5 * rng.normal(size=500),
                Z[:, 1] - Z[:, 2], rng.random(500),
                np.zeros(500)], 1)          # the last: one class, dropped
  names = ["CD4", "CD8", "noise", "flat"]
  want = JA.streamline_classifier(Z[:400], y[:400], Z[400:], y[400:],
                                  names)
  got = TA.streamline_classifier(torch.as_tensor(Z[:400]), y[:400],
                                 torch.as_tensor(Z[400:]), y[400:], names,
                                 device="cpu")
  for w, g in zip(want, got):
    assert list(g) == list(w) == ["CD4", "CD8", "noise", "F1micro",
                                  "F1macro"]
    for k in w:
      assert abs(g[k] - w[k]) <= 0.01, k
  assert TA.streamline_classifier(Z, np.zeros((500, 2)), Z,
                                  np.zeros((500, 2)), ["a", "b"]) == ({}, {})


# --------------------------------------------------------- the callback
def test_clustering_scores_callback_logs_as_jax():
  import sisua_tpu.models as J
  from sisua_tpu.data import generate_synthetic
  from sisua_tpu.rv import RVmeta as JRV
  from sisua_tpu.train.trainer import TrainingCallback as JCallback
  from sisua_tpu_torch import models as T
  from sisua_tpu_torch.rv import RVmeta as TRV
  from sisua_tpu_torch.train import TrainingCallback as TCallback
  sco = generate_synthetic(n_cells=240, n_genes=40, n_proteins=6,
                           n_celltypes=3, seed=5218)
  train, test = sco.split(0.75, seed=1)

  def recorder(base):
    class Recorder(base):
      def __init__(self):
        self.seen = []

      def on_epoch_end(self, epoch, logs):
        self.seen.append((epoch, sorted(
            k for k in logs if k.startswith("ClusteringScores"))))
    return Recorder()
  small = dict(encoder={"units": [16]}, decoder={"units": [16]})
  jrec = recorder(JCallback)
  jm = J.VAE(JRV(train.n_vars, "zinb", name="rna"), **small)
  jm.fit(train, epochs=3, batch_size=64,
         callbacks=[JA.ClusteringScores(sco=test, freq=2), jrec])
  trec = recorder(TCallback)
  tm = T.VAE(TRV(train.n_vars, "zinb", name="rna"), device="cpu", **small)
  cb = TA.ClusteringScores(data=[np.asarray(test.numpy(), np.float32)],
                           labels=test.numpy("celltype"), freq=2)
  tm.fit(np.asarray(train.numpy(), np.float32), epochs=3, batch_size=64,
         callbacks=[cb, trec])
  assert trec.seen == jrec.seen
  assert trec.seen[0][1] == ["ClusteringScores_ARI", "ClusteringScores_ASW",
                             "ClusteringScores_NMI", "ClusteringScores_UCA"]
  for _, keys in trec.seen:
    for k in keys:
      assert np.isfinite(tm.history[k]).all(), k
  # call() on whole distributions scores as the JAX callback on the same
  # latent means
  import sisua_tpu.dist as JD
  import sisua_tpu_torch.dist as TD
  loc = np.random.default_rng(9).normal(size=(test.n_obs, 4)).astype(
      np.float32)
  loc += 3 * np.eye(3, 4, dtype=np.float32)[test.numpy("celltype").argmax(1)]
  jq = JD.MultivariateNormalDiag(loc=loc, scale_diag=np.ones_like(loc))
  tq = TD.MultivariateNormalDiag(loc=torch.as_tensor(loc),
                                 scale_diag=torch.ones(loc.shape))
  want = JA.ClusteringScores(sco=test).call(None, None, jq)
  got = cb.call(None, None, tq)
  assert list(got) == list(want)
  for k in want:
    assert abs(got[k] - want[k]) <= 1e-6, k
  assert TA.ClusteringScores(data=[test.numpy()]).call(None, None, tq) == {}

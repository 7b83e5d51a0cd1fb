"""The port's estimators (``sisua_tpu_torch.analysis.estimators``) against
sklearn, and its ``ProbabilisticEmbedding`` against the JAX package's.

* ARI, NMI, MI, silhouette and F1 equal sklearn's within 1e-10 on random
  and tied labels, and raise where sklearn raises.
* KMeans (10 restarts) and both GaussianMixture kinds give sklearn's
  partitions up to relabeling (ARI 1) on planted blobs and on points with
  no cluster structure, with inertia / lower bound within 1e-6 relative;
  the same draws, since both seed a numpy ``RandomState``.
* ``LinearSVC`` (one-vs-rest) agrees with liblinear on ≥ 99% of the rows,
  F1 within 0.01: liblinear stops at a relative gradient of 1e-4, the port
  solves the same objective to its minimum.
* ``LogisticRegression.score`` equals sklearn's (lbfgs stops at its
  tolerance; the port reaches the unique optimum).
* The boosted trees' ``feature_importances_`` within 1e-6 and ``score``
  equal, binary and 4 classes. No tie between features was met on these
  inputs; exactly equal float32 values within a node are where the order
  of the port's stable sort and sklearn's introsort could differ.
* Every entry point but the boosted trees computes on ``device``, whose
  default is 'cuda': without a card it raises, with no CPU fallback.
* ``ProbabilisticEmbedding.predict`` gives the JAX package's bins on
  planted bimodal protein counts; its float32 mixtures' parameters agree
  within 1e-5 relative, their log-densities within 5e-3 (float32 EM
  stopped at sklearn's tolerance, summed in another order).
"""

import numpy as np
import pytest
import torch
from sklearn import metrics as M
from sklearn.cluster import KMeans as SKKMeans
from sklearn.ensemble import GradientBoostingClassifier as SKGB
from sklearn.linear_model import LogisticRegression as SKLogReg
from sklearn.mixture import GaussianMixture as SKGMM
from sklearn.multiclass import OneVsRestClassifier
from sklearn.svm import LinearSVC as SKLinearSVC

from sisua_tpu_torch.analysis import estimators as E
from torch_port_threads import _one_thread  # noqa: F401


TOL = 1e-10


def _labels(case):
  rng = np.random.default_rng(0)
  n = 300
  if case == "random":
    return rng.integers(0, 4, n), rng.integers(0, 6, n)
  if case == "equal_relabeled":
    a = rng.integers(0, 5, n)
    return a, (a + 2) % 5
  if case == "one_cluster_each":
    return np.zeros(n, int), np.full(n, 3)
  if case == "one_side_single":
    return np.zeros(n, int), rng.integers(0, 3, n)
  if case == "all_distinct":
    return rng.integers(0, 2, n), np.arange(n)
  if case == "tied_strings":
    return (np.array(["b", "a", "a", "c"] * 75),
            np.array([7, 7, 1, 1] * 75))
  raise ValueError(case)


LABEL_CASES = ["random", "equal_relabeled", "one_cluster_each",
               "one_side_single", "all_distinct", "tied_strings"]


@pytest.mark.parametrize("case", LABEL_CASES)
@pytest.mark.parametrize("name", ["adjusted_rand_score",
                                  "normalized_mutual_info_score",
                                  "mutual_info_score"])
def test_label_scores_equal_sklearn(name, case):
  a, b = _labels(case)
  want = getattr(M, name)(a, b)
  if a.dtype.kind in "iu":
    a = torch.as_tensor(a)  # tensors and arrays alike
  assert abs(getattr(E, name)(a, b, device="cpu") - want) <= TOL


@pytest.mark.parametrize("case", ["random", "duplicates", "singletons"])
def test_silhouette_equals_sklearn(case, monkeypatch):
  rng = np.random.default_rng(1)
  X = rng.normal(size=(257, 5))
  lab = rng.integers(0, 4, 257)
  if case == "duplicates":
    X[100:140] = X[0]           # tied points across clusters
  if case == "singletons":
    lab[:3] = [10, 11, 12]      # clusters of one score 0
  # small blocks so the row tiling runs several times
  monkeypatch.setattr(E, "_SIL_BUDGET", 8 * 257 * 60)
  got = E.silhouette_score(torch.as_tensor(X), lab, device="cpu")
  assert abs(got - M.silhouette_score(X, lab)) <= TOL


@pytest.mark.parametrize("labels", [np.zeros(10, int), np.arange(10)])
def test_silhouette_raises_as_sklearn(labels):
  X = np.random.default_rng(2).normal(size=(10, 3))
  with pytest.raises(ValueError):
    M.silhouette_score(X, labels)
  with pytest.raises(ValueError):
    E.silhouette_score(X, labels, device="cpu")


def test_f1_equals_sklearn():
  rng = np.random.default_rng(3)
  yt = rng.integers(0, 2, (120, 5))
  yp = rng.integers(0, 2, (120, 5))
  yt[:, 3] = 0
  yp[:, 3] = 0                          # no positive at all: 0
  yp[:, 4] = 0                          # nothing predicted: 0
  for j in range(5):
    assert abs(E.f1_score(yt[:, j], yp[:, j], device="cpu") - M.f1_score(
        yt[:, j], yp[:, j], zero_division=0)) <= TOL
  for avg in ("micro", "macro"):
    assert abs(E.f1_score(yt, yp, average=avg, device="cpu") - M.f1_score(
        yt, yp, average=avg, zero_division=0)) <= TOL


def _blobs(seed, n=1200, k=4, d=6):
  rng = np.random.default_rng(seed)
  centres = rng.normal(0, 6, (k, d))
  return centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))


DATA = {"blobs": lambda: _blobs(4),
        "no_structure": lambda: np.random.default_rng(5).normal(
            size=(900, 4))}


def _same_partition(a, b):
  return M.adjusted_rand_score(np.asarray(a), np.asarray(b)) == 1.0


@pytest.mark.parametrize("data", list(DATA))
def test_kmeans_equals_sklearn(data):
  X = DATA[data]()
  sk = SKKMeans(4, n_init=10, random_state=8).fit(X)
  km = E.KMeans(4, n_init=10, random_state=8, device="cpu").fit(X)
  assert _same_partition(sk.labels_, km.labels_.numpy())
  assert abs(km.inertia_ / sk.inertia_ - 1) <= 1e-6
  np.testing.assert_allclose(
      np.sort(km.cluster_centers_.numpy(), 0),
      np.sort(sk.cluster_centers_, 0), rtol=1e-6, atol=1e-8)


def test_kmeans_float32_and_errors():
  X = _blobs(6, n=500).astype(np.float32)
  sk = SKKMeans(3, n_init=10, random_state=1).fit(X)
  km = E.KMeans(3, n_init=10, random_state=1, device="cpu").fit(X)
  assert km.cluster_centers_.dtype == torch.float32
  assert _same_partition(sk.labels_, km.labels_.numpy())
  with pytest.raises(ValueError):
    E.KMeans(5, device="cpu").fit(X[:4])


@pytest.mark.parametrize("cov", ["full", "diag"])
@pytest.mark.parametrize("data", list(DATA))
def test_gaussian_mixture_equals_sklearn(data, cov):
  X = DATA[data]()
  sk = SKGMM(4, covariance_type=cov, random_state=8)
  want = sk.fit_predict(X)
  gm = E.GaussianMixture(4, covariance_type=cov, random_state=8,
                         device="cpu")
  got = gm.fit_predict(torch.as_tensor(X)).numpy()
  assert _same_partition(want, got)
  assert gm.n_iter_ == sk.n_iter_
  assert abs(gm.lower_bound_ / sk.lower_bound_ - 1) <= 1e-6
  np.testing.assert_allclose(gm.score_samples(X).numpy(),
                             sk.score_samples(X), rtol=1e-6)
  np.testing.assert_allclose(gm.predict_proba(X).numpy().sum(1), 1.0,
                             rtol=1e-12)
  with pytest.raises(ValueError):
    E.GaussianMixture(5, covariance_type=cov, device="cpu").fit(X[:4])


def test_diag_mixture_restarts_on_one_column():
  """ProbabilisticEmbedding's fit: 1-D float32, 8 restarts, 120 steps."""
  rng = np.random.default_rng(7)
  x = np.concatenate([rng.normal(1, 0.3, 400), rng.normal(4, 0.5, 200)])
  x = x.astype(np.float32)[:, None]
  kw = dict(n_components=2, covariance_type="diag", n_init=8,
            max_iter=120, random_state=8)
  sk = SKGMM(**kw).fit(x)
  gm = E.GaussianMixture(**kw, device="cpu").fit(x)
  np.testing.assert_allclose(np.sort(gm.means_.numpy().ravel()),
                             np.sort(sk.means_.ravel()), rtol=1e-5)
  assert _same_partition(sk.predict(x), gm.predict(x).numpy())


def test_linear_svc_one_vs_rest_agrees_with_liblinear():
  rng = np.random.default_rng(8)
  Z = rng.normal(size=(600, 8))
  Y = np.stack([(Z[:, :3].sum(1) + rng.normal(size=600) > 0),
                (Z[:, 3] - Z[:, 4] > 0.5),
                (Z[:, 5] + 0.3 * rng.normal(size=600) > 1.0)], 1).astype(int)
  sk = OneVsRestClassifier(SKLinearSVC(random_state=8)).fit(Z, Y)
  svc = E.LinearSVC(device="cpu").fit(torch.as_tensor(Z), Y)
  want, got = sk.predict(Z), svc.predict(Z).numpy()
  assert (want == got).mean() >= 0.99
  for j in range(Y.shape[1]):
    assert abs(M.f1_score(Y[:, j], got[:, j])
               - M.f1_score(Y[:, j], want[:, j])) <= 0.01
  # one binary problem
  one = E.LinearSVC(device="cpu").fit(Z, Y[:, 0])
  assert (one.predict(Z).numpy() == SKLinearSVC().fit(
      Z, Y[:, 0]).predict(Z)).mean() >= 0.99


@pytest.mark.parametrize("k", [2, 5])
def test_logistic_regression_scores_equal_sklearn(k):
  rng = np.random.default_rng(9 + k)
  y = rng.integers(0, k, 900)
  X = rng.normal(size=(900, 6)) + 0.4 * y[:, None] * np.linspace(
      1, -1, 6)[None]
  sk = SKLogReg(max_iter=500, random_state=8).fit(X[:700], y[:700])
  lr = E.LogisticRegression(device="cpu").fit(X[:700], y[:700])
  assert lr.score(X[700:], y[700:]) == sk.score(X[700:], y[700:])
  np.testing.assert_allclose(lr.coef_.numpy(), sk.coef_, atol=5e-3)


@pytest.mark.parametrize("k", [2, 4])
def test_boosted_trees_equal_sklearn(k):
  rng = np.random.default_rng(20 + k)
  y = rng.integers(0, k, 500)
  X = rng.normal(size=(500, 6)) + y[:, None] * np.array(
      [0.6, 0.0, 0.3, 0.0, 0.1, 0.0])
  kw = dict(n_estimators=30, max_depth=3, random_state=8)
  sk = SKGB(**kw).fit(X[:400], y[:400])
  gb = E.GradientBoostingClassifier(**kw).fit(X[:400], y[:400])
  np.testing.assert_allclose(gb.feature_importances_,
                             sk.feature_importances_, atol=1e-6)
  assert gb.score(X[400:], y[400:]) == sk.score(X[400:], y[400:])
  # the trees themselves, node by node
  for stage_s, stage_p in zip(sk.estimators_, gb.estimators_):
    for ts, tp in zip(stage_s, stage_p):
      assert ts.tree_.feature.tolist() == tp.feature
      np.testing.assert_array_equal(ts.tree_.threshold, tp.threshold)


def _bimodal_proteins(seed, n=500, p=5):
  rng = np.random.default_rng(seed)
  pos = rng.random((n, p)) < 0.4
  counts = np.where(pos, rng.poisson(200, (n, p)), rng.poisson(8, (n, p)))
  counts[:, -1] = 0                  # a degenerate column: the fallback
  counts[:50, -2] = 0                # zeros beside the modes: the anchor
  return counts.astype(np.float32)


def test_probabilistic_embedding_bins_equal_jax():
  from sisua_tpu.label_threshold import ProbabilisticEmbedding as JPE
  from sisua_tpu_torch.label_threshold import ProbabilisticEmbedding as TPE
  X = _bimodal_proteins(10)
  jpe, tpe = JPE().fit(X), TPE(device="cpu").fit(torch.as_tensor(X))
  np.testing.assert_array_equal(tpe.predict(X), jpe.predict(X))
  np.testing.assert_allclose(tpe.predict_proba(X), jpe.predict_proba(X),
                             rtol=1e-4, atol=1e-6)
  np.testing.assert_allclose(tpe.means, jpe.means, rtol=1e-5)
  # both mixtures run EM in float32 and stop at a lower-bound change of
  # 1e-3, summing in another order: their log-densities differ by ~1e-3
  np.testing.assert_allclose(tpe.score_samples(X), jpe.score_samples(X),
                             atol=5e-3)


def _entry_points():
  from sisua_tpu_torch.analysis import (Criticizer, clustering_scores,
                                        streamline_classifier)
  from sisua_tpu_torch.label_threshold import ProbabilisticEmbedding
  X = _blobs(11, n=60, k=2, d=3)
  ids = np.arange(60) % 2
  return {
      "adjusted_rand_score": lambda: E.adjusted_rand_score(ids, ids),
      "normalized_mutual_info_score":
          lambda: E.normalized_mutual_info_score(ids, ids),
      "mutual_info_score": lambda: E.mutual_info_score(ids, ids),
      "silhouette_score": lambda: E.silhouette_score(X, ids),
      "f1_score": lambda: E.f1_score(ids, ids),
      "KMeans": lambda: E.KMeans(2).fit(X),
      "GaussianMixture": lambda: E.GaussianMixture(2).fit(X),
      "LinearSVC": lambda: E.LinearSVC().fit(X, ids),
      "LogisticRegression": lambda: E.LogisticRegression().fit(X, ids),
      "clustering_scores": lambda: clustering_scores(X, ids),
      "streamline_classifier": lambda: streamline_classifier(
          X, np.eye(2)[ids], X, np.eye(2)[ids], ["a", "b"]),
      "Criticizer": lambda: Criticizer(X, np.eye(2)[ids]),
      "ProbabilisticEmbedding": lambda: ProbabilisticEmbedding().fit(
          _bimodal_proteins(12, n=60, p=2)),
  }


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour without a card")
@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
  with pytest.raises(RuntimeError, match="device='cuda'"):
    _entry_points()[name]()

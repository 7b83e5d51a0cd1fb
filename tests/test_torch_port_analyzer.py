"""The port's data analyzer (``sisua_tpu_torch/data/analysis.py`` on
``SingleCellOMIC``, with ``analysis/{decomposition,cluster,stats}.py``)
against the JAX analyzer, on the JAX suite's dataset
(``generate_synthetic(600, 80, 8 proteins, 4 cell types, seed 5218)``;
the port's generator is bitwise the JAX one). The port runs with
``device='cpu'``. Tolerances:

  * selections (filters, QC selections, ``top_vars``, marker pairs, the
    Hungarian mapping, KMeans/agglomerative/Louvain labels, rank-test
    names): equal. Spectral labels: ARI 1;
  * float32 values: rel 1e-6 (the column sums follow numpy's float32 row
    order). Values that are z-scores or centred data, which cross 0, are
    held to 1e-6 of their largest magnitude;
  * PCA in float32: the first 10 components and score columns within
    5e-5 (of each column's range), every one within 2e-4: sklearn's
    LAPACK ``sgesdd`` and torch's differ on this data by 1.8e-5 on the
    unit components with torch's threads, by 7.7e-5 (components) and
    1.1e-4 (scores, the 80-component 'full' case) with one thread, in
    components whose singular values lie close; in float64 the same
    solvers agree to 1e-10;
  * neighbours on the same embedding: distances rel 1e-6 of sklearn's
    (its brute search ranks by ‖x‖² − 2x·y + ‖y‖² and keeps that
    rounding: 4e-5 on distances of ~1e3 here; a row's own distance is
    that rounding, the port's 0), indices equal except where two
    neighbours' exact distances lie closer than that rounding (4 of 7,200
    here), which sklearn orders by its rounding;
  * rank tests: scores and p-values rel 1e-6 (measured equal: the port
    reduces in numpy's order and keeps scipy's float32);
  * correlations: Pearson 1e-6, Spearman 1e-9;
  * mutual information (sklearn backend) 1e-9; the 'jax' backend is the
    port's ``ops.knn_mi`` (held to JAX in ``test_torch_port_knn_mi``);
  * random-forest importances 1e-9 at 200 cells × 20 genes, 4 trees,
    2 proteins.
"""

import numpy as np
import pytest
import torch

import sisua_tpu.data.analysis as JA
import sisua_tpu_torch.data.analysis as TA

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """One torch, BLAS and OpenMP thread: the tier runs several test
  processes on the machine's cores, and these tests' many small
  operations would otherwise wait on each other's thread pools. The
  t-SNE library is loaded first, so that its OpenMP team is limited
  too."""
  from threadpoolctl import threadpool_limits
  from sisua_tpu_torch import native
  native.load("tsne")
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
  from sisua_tpu.data import generate_synthetic as jgen
  from sisua_tpu_torch.data import generate_synthetic as tgen
  kw = dict(n_cells=600, n_genes=80, n_proteins=8, n_celltypes=4,
            seed=5218)
  return jgen(**kw), tgen(**kw)


def _rel(got, want, rtol=1e-6):
  np.testing.assert_allclose(np.asarray(got, np.float64),
                             np.asarray(want, np.float64), rtol=rtol,
                             atol=0)


def _scaled(got, want, tol=1e-6):
  want = np.asarray(want, np.float64)
  np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                             atol=tol * np.abs(want).max())


# ----------------------------------------------------------------- container
def test_container_surface_as_jax(pair):
  j, t = (s.copy() for s in pair)
  for k in ("total", "log_counts", "local_mean", "local_var"):
    np.testing.assert_array_equal(t.stats()[k], j.stats()[k])
  np.testing.assert_array_equal(t.get_library_size(), j.get_library_size())
  for f in ("total_counts", "log_counts", "local_mean", "local_var"):
    np.testing.assert_array_equal(getattr(t, f)("proteomic"),
                                  getattr(j, f)("proteomic"))
  assert t.sparsity() == j.sparsity()
  np.testing.assert_array_equal(t.counts_per_cell(), j.counts_per_cell())
  np.testing.assert_array_equal(t.counts_per_gene(), j.counts_per_gene())
  np.testing.assert_array_equal(t.labels("celltype"),
                                j.labels("celltype").values)
  assert t.get_labels_name("celltype") == j.get_labels_name("celltype")
  assert t.get_var_indices("proteomic") == j.get_var_indices("proteomic")
  assert t.md5 == j.md5 and t == t.copy() and not t == t[:10]
  assert t.shape == j.shape and t.n_omics == j.n_omics == 3
  assert t.is_binary("celltype") == j.is_binary("celltype")
  assert t.is_categorical("celltype") == j.is_categorical("celltype")
  assert t.describe().splitlines()[1:] == j.describe().splitlines()[1:]
  # set_omic, the X setter (statistics refreshed) and apply_indices
  for s, kw in ((j, {}), (t, {"device": CPU})):
    s.dimension_reduce(n_components=10, **kw)
    s.set_omic("proteomic")
    s.X = s.X * 2
    s.set_omic("transcriptomic")
    s.apply_indices(np.arange(0, 600, 2))
    s.apply_indices(np.arange(40), observation=False)
  np.testing.assert_array_equal(t.stats("proteomic")["local_mean"],
                                j.stats("proteomic")["local_mean"])
  np.testing.assert_array_equal(t.get_var_names(), j.var_names.values)
  np.testing.assert_array_equal(t.numpy(), j.numpy())
  assert sorted(t.obsm) == sorted(j.obsm) == []     # the PCA was dropped
  assert [h[0] for h in t.history] == [h[0] for h in j.history]
  t.set_verbose(True)
  assert t.verbose and "current=transcriptomic" in repr(t)


def test_marker_tables_as_jax():
  import sisua_tpu.data.const as JC
  import sisua_tpu_torch.data.const as TC
  for name in ("MARKER_GENES", "MARKER_ATAC", "PROTEIN_PAIR_POSITIVE",
               "PROTEIN_PAIR_NEGATIVE", "TSNE_DIM", "MARKER_ADT_GENE"):
    assert getattr(TC, name) == getattr(JC, name), name
  omics = ("transcriptomic", "itranscriptomic", "proteomic", "iproteomic",
           "atac", "celltype")
  for a in omics:
    assert TC.omic_markers(a) == JC.OMIC.parse(a).markers
    for b in omics:
      assert TC.marker_pairs(a, b) == JC.OMIC.parse(a).marker_pairs(b)


# ------------------------------------------------------------- QC, filters
def test_quality_metrics_and_top_vars_as_jax(pair):
  j, t = (s.copy() for s in pair)
  j.calculate_quality_metrics()
  t.calculate_quality_metrics(device=CPU)
  for k in ("n_vars_by_counts", "total_counts", "pct_counts_in_top_50_vars"):
    _rel(t.obs[f"transcriptomic_{k}"], j.obs[f"transcriptomic_{k}"].values)
  for k in ("n_cells_by_counts", "total_counts", "mean_counts",
            "pct_dropout_by_counts"):
    _rel(t.get_var()[k], j.var[k].values)
  for n in (5, 30, 100):
    np.testing.assert_array_equal(t.top_vars(n_vars=n, device=CPU),
                                  j.top_vars(n_vars=n))
  assert t.get_marker_pairs() == j.get_marker_pairs()
  names = ["CD14", "FUT4", "CD19"]
  assert t.get_marker_pairs(var_names1=names) == j.get_marker_pairs(
      var_names1=names)
  assert t.get_marker_pairs("proteomic", "transcriptomic") == \
      j.get_marker_pairs("proteomic", "transcriptomic")


@pytest.mark.parametrize("flavor", ["seurat", "cell_ranger"])
@pytest.mark.parametrize("n_top", [None, 30])
def test_highly_variable_genes_as_jax(pair, flavor, n_top):
  j, t = (s.copy() for s in pair)
  j.filter_highly_variable_genes(n_top_genes=n_top, flavor=flavor)
  t.filter_highly_variable_genes(n_top_genes=n_top, flavor=flavor,
                                 device=CPU)
  np.testing.assert_array_equal(t.get_var_names(), j.var_names.values)
  np.testing.assert_array_equal(t.get_var()["highly_variable"],
                                j.var["highly_variable"].values)
  _rel(t.get_var()["means"], j.var["means"].values)
  _scaled(t.get_var()["dispersions_norm"], j.var["dispersions_norm"].values)
  np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_count_filters_normalize_expm1_as_jax(pair):
  j, t = (s.copy() for s in pair)
  j.filter_genes(min_cells=100, max_counts=20000)
  t.filter_genes(min_cells=100, max_counts=20000, device=CPU)
  np.testing.assert_array_equal(t.get_var_names(), j.var_names.values)
  j.filter_cells(min_counts=600, max_genes=75)
  t.filter_cells(min_counts=600, max_genes=75, device=CPU)
  np.testing.assert_array_equal(t.obs["cell_id"], j.obs.index.values)
  np.testing.assert_array_equal(t.get_library_size("proteomic"),
                                j.get_library_size("proteomic"))
  j.normalize(total=True, log1p=True)
  t.normalize(total=True, log1p=True, device=CPU)
  _rel(t.numpy(), j.numpy())
  j.normalize("proteomic", scale=True, max_value=2.0)
  t.normalize("proteomic", scale=True, max_value=2.0, device=CPU)
  _scaled(t.numpy("proteomic"), j.numpy("proteomic"))
  j.expm1()
  t.expm1(device=CPU)
  _rel(t.numpy(), j.numpy())
  j.normalize(total=True, target_sum=1e4)
  t.normalize(total=True, target_sum=1e4, device=CPU)
  _rel(t.numpy(), j.numpy())
  assert [h[0] for h in t.history] == [h[0] for h in j.history]


def test_probabilistic_embedding_as_jax(pair):
  j, t = (s.copy() for s in pair)
  jm, jp, jb = j.probabilistic_embedding("proteomic")
  tm, tp, tb = t.probabilistic_embedding("proteomic", device=CPU)
  np.testing.assert_array_equal(tb, jb)
  np.testing.assert_allclose(tp, jp, atol=1e-3)
  np.testing.assert_array_equal(t.get_x_bins("proteomic", device=CPU), jb)
  assert sorted(t.uns) == sorted(j.uns) and sorted(t.obsm) == sorted(j.obsm)


# ----------------------------------------------------------- embeddings
def _components(model):
  c = model.components_
  return c.numpy() if isinstance(c, torch.Tensor) else c


@pytest.mark.parametrize("batch,n", [(4096, 100), (4096, 50), (4096, 10),
                                     (256, 100), (256, 30)])
def test_pca_and_incremental_pca_as_jax(pair, monkeypatch, batch, n):
  monkeypatch.setattr(JA, "BATCH_SIZE", batch)
  monkeypatch.setattr(TA, "BATCH_SIZE", batch)
  j, t = (s.copy() for s in pair)
  a = j.dimension_reduce(n_components=n)
  b = t.dimension_reduce(n_components=n, device=CPU)
  jm, tm = j.uns["transcriptomic_pca_model"], t.uns[
      "transcriptomic_pca_model"]
  if batch == 4096:
    assert tm.svd_solver_ == jm._fit_svd_solver
  else:
    assert type(tm).__name__ == type(jm).__name__ == "IncrementalPCA"
  comps = _components(tm)
  np.testing.assert_allclose(comps[:10], jm.components_[:10], rtol=0,
                             atol=5e-5)
  np.testing.assert_allclose(comps, jm.components_, rtol=0, atol=2e-4)
  assert a.shape == b.shape and b.dtype == np.float32
  for col in range(a.shape[1]):
    np.testing.assert_allclose(b[:, col], a[:, col], rtol=0,
                               atol=(5e-5 if col < 10 else 2e-4)
                               * np.abs(a[:, col]).max())
  # the cache: a narrower request is a slice, a wider one recomputes
  np.testing.assert_array_equal(t.dimension_reduce(n_components=5,
                                                   device=CPU), b[:, :5])


@pytest.mark.parametrize("shape,n", [((600, 80), 80), ((900, 120), 40),
                                     ((2000, 60), 20), ((300, 700), 20)])
def test_pca_float64_follows_every_sklearn_solver(shape, n):
  """In float64 each solver is sklearn's to 1e-10 (full, randomized,
  covariance_eigh, and a wide matrix, which the randomized solver
  transposes)."""
  from sklearn.decomposition import PCA as SKPCA
  from sklearn.decomposition import IncrementalPCA as SKIPCA

  from sisua_tpu_torch.analysis.decomposition import PCA, IncrementalPCA
  rng = np.random.default_rng(shape[0])
  X = rng.gamma(0.6, 2.0, shape) @ rng.normal(size=(shape[1], shape[1]))
  sk = SKPCA(n, random_state=3)
  want = sk.fit_transform(X)
  port = PCA(n, random_state=3, device=CPU)
  got = port.fit_transform(X).numpy()
  assert port.svd_solver_ == sk._fit_svd_solver
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(
      want).max())
  np.testing.assert_allclose(port.explained_variance_ratio_.numpy(),
                             sk.explained_variance_ratio_, rtol=1e-10)
  ski = SKIPCA(n, batch_size=max(n, shape[0] // 3))
  want = ski.fit_transform(X)
  got = IncrementalPCA(n, batch_size=max(n, shape[0] // 3),
                       device=CPU).fit_transform(X).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(
      want).max())


def test_tsne_is_refused_with_its_reason(pair):
  """t-SNE was refused until the port had sklearn's Barnes-Hut t-SNE; it
  now runs as the JAX analyzer's does, on the same 100-PC embedding
  (given to both: the float32 PCAs differ in the last bits, which the
  descent amplifies): the key, the shape, the history entry, the
  trustworthiness of the 3-D embedding against its 50-PC input within
  0.02, and the KL divergence of each embedding under the same P (the
  Barnes-Hut error t-SNE reports) within 2% (measured 6.9e-4 and 0.3%
  apart). An unknown algorithm still raises."""
  from sisua_tpu_torch import native
  from sisua_tpu_torch.analysis import manifold as M
  j, t = (s.copy() for s in pair)
  emb = j.dimension_reduce(n_components=80)
  t.obsm["transcriptomic_pca"] = emb.copy()
  want = j.dimension_reduce(algo="tsne")
  got = t.dimension_reduce(algo="tsne", device=CPU)
  assert "transcriptomic_tsne" in t.obsm and "transcriptomic_tsne" in j.obsm
  assert got.shape == want.shape == (600, 3) and got.dtype == np.float32
  assert t.history[-1] == j.history[-1] == (
      "dimension_reduce", {"omic": "transcriptomic", "algo": "tsne",
                           "n_components": 3})
  X = torch.as_tensor(emb[:, :50])
  tw_j = M.trustworthiness(X, want, n_neighbors=12, device=CPU)
  tw_t = M.trustworthiness(X, got, n_neighbors=12, device=CPU)
  assert abs(tw_t - tw_j) <= 0.02 and tw_t > 0.9
  indptr, indices, P = M._joint_probabilities_nn(*M._kneighbors(X, 91), 30.0)
  kl = [native.tsne_gradient(P.float().numpy(), e, indices.numpy(),
                             indptr.numpy(), dof=2, num_threads=1)[0]
        for e in (want, got)]
  assert abs(kl[1] - kl[0]) <= 0.02 * kl[0], kl
  with pytest.raises(ValueError):
    t.dimension_reduce(algo="isomap", device=CPU)


def test_neighbors_as_jax(pair):
  j, t = (s.copy() for s in pair)
  emb = j.dimension_reduce(n_components=80)
  t.obsm["transcriptomic_pca"] = emb.copy()   # the same embedding
  gj, gt = j.neighbors(n_pcs=80), t.neighbors(n_pcs=80, device=CPU)
  assert gt["n_neighbors"] == gj["n_neighbors"] == 12
  for k in ("distances", "connectivities"):
    np.testing.assert_array_equal(gt[k].indptr, gj[k].indptr)
  np.testing.assert_array_equal(gt["connectivities"].indices,
                                gt["distances"].indices)
  _rel(gt["connectivities"].data, gj["connectivities"].data)
  # where sklearn's rounding (below 1e-4 here) ordered two neighbours
  # whose exact distances are closer than it, the order may differ:
  # every other index is equal
  ti, ji = gt["distances"].indices, gj["distances"].indices
  swap = np.flatnonzero(ti != ji)
  rows = np.repeat(np.arange(600), 12)
  exact = np.linalg.norm(emb[rows].astype(np.float64)
                         - emb[ti].astype(np.float64), axis=1)
  exact_j = np.linalg.norm(emb[rows].astype(np.float64)
                           - emb[ji].astype(np.float64), axis=1)
  assert len(swap) <= 8
  np.testing.assert_allclose(exact[swap], exact_j[swap], rtol=0, atol=1e-4)
  np.testing.assert_allclose(gt["distances"].data, exact, rtol=1e-12)
  off = ti == ji
  _rel(gt["distances"].data[off & (exact > 1.0)],
       gj["distances"].data[off & (exact > 1.0)])
  assert gt is t.neighbors(n_pcs=80, device=CPU)          # cached


# ------------------------------------------------------------- clustering
@pytest.mark.parametrize("algo", ["kmeans", "agglo", "spectral"])
def test_clustering_as_jax(pair, algo):
  from sklearn.metrics import adjusted_rand_score
  j, t = (s.copy() for s in pair)
  a = j.clustering(algo=algo, matching_labels="celltype")
  key = t.clustering(algo=algo, matching_labels="celltype", device=CPU,
                     return_key=True)
  assert key == j.clustering(algo=algo, matching_labels="celltype",
                             return_key=True)
  b = t.obs[key]
  if algo == "spectral":
    assert adjusted_rand_score(a, b) == 1.0
  else:
    np.testing.assert_array_equal(b, a)
  assert t.clustering(algo=algo, n_clusters=3, device=CPU).shape == (600,)


def test_gmm_clustering_as_jax():
  """At 80 PCs the JAX mixture raises on this data (ill-defined float32
  covariances) and so does the port's; on 10 genes both cluster."""
  from sisua_tpu.data import generate_synthetic as jgen
  from sisua_tpu_torch.data import generate_synthetic as tgen
  kw = dict(n_cells=600, n_genes=80, n_proteins=8, n_celltypes=4,
            seed=5218)
  with pytest.raises(ValueError, match="ill-defined"):
    jgen(**kw).clustering(algo="gmm")
  with pytest.raises(ValueError, match="ill-defined"):
    tgen(**kw).clustering(algo="gmm", device=CPU)
  kw["n_genes"] = 10
  a = jgen(**kw).clustering(algo="gmm", matching_labels="celltype")
  b = tgen(**kw).clustering(algo="gmm", matching_labels="celltype",
                            device=CPU)
  np.testing.assert_array_equal(b, a)


def test_spectral_clustering_class_as_sklearn():
  """A connected affinity (the analyzer's PCA scores give an almost
  diagonal one at γ = 1): blobs at unit scale."""
  from sklearn.cluster import SpectralClustering as SK
  from sklearn.metrics import adjusted_rand_score

  from sisua_tpu_torch.analysis.cluster import SpectralClustering
  rng = np.random.default_rng(3)
  X = np.concatenate([c + rng.normal(0, 0.6, (60, 3)) for c in
                      rng.normal(0, 2, (4, 3))]).astype(np.float32)
  want = SK(4, random_state=5, assign_labels="discretize").fit_predict(X)
  got = SpectralClustering(4, random_state=5, device=CPU).fit_predict(X)
  assert adjusted_rand_score(got.numpy(), want) == 1.0


def test_louvain_as_jax(pair):
  j, t = (s.copy() for s in pair)
  for res in (1.0, 0.5):
    a = j.louvain(resolution=res)
    b = t.louvain(resolution=res, device=CPU)
    np.testing.assert_array_equal(b, a)
  assert t.louvain(return_key=True, device=CPU) == j.louvain(
      return_key=True)


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("method", ["t-test", "wilcoxon"])
def test_rank_vars_groups_as_jax(pair, method):
  j, t = (s.copy() for s in pair)
  for n in (100, 10):
    want = j.rank_vars_groups(method=method, n_vars=n)
    got = t.rank_vars_groups(method=method, n_vars=n, device=CPU)
    assert list(got) == list(want)
    for g in want:
      np.testing.assert_array_equal(got[g]["names"],
                                    want[g]["names"].values)
      _rel(got[g]["scores"], want[g]["scores"].values)
      _rel(got[g]["pvals"], want[g]["pvals"].values)
  assert "transcriptomic_rank_celltype" in t.uns


def test_mann_whitney_small_groups_as_scipy():
  """Groups of at most 8 without ties take scipy's exact p-values."""
  from scipy import stats

  from sisua_tpu_torch.analysis.stats import mannwhitneyu
  rng = np.random.default_rng(2)
  X = rng.normal(size=(20, 6)).astype(np.float32)
  X[:, 5] = np.round(X[:, 5])                  # ties: asymptotic
  g = np.zeros(20, bool)
  g[:6] = True
  U, p = mannwhitneyu(X, g, device=CPU)
  for c in range(6):
    r = stats.mannwhitneyu(X[g, c], X[~g, c])
    assert U[c] == r.statistic and p[c] == r.pvalue


def test_correlation_as_jax(pair):
  j, t = (s.copy() for s in pair)
  want, got = j.get_correlation(), t.get_correlation(device=CPU)
  assert len(got) == len(want) == 80 * 8
  w = {(a, b): (p, s) for a, b, p, s in want}
  g = {(a, b): (p, s) for a, b, p, s in got}
  assert set(g) == set(w)
  np.testing.assert_allclose([g[k][0] for k in w], [w[k][0] for k in w],
                             rtol=0, atol=1e-6)
  np.testing.assert_allclose([g[k][1] for k in w], [w[k][1] for k in w],
                             rtol=0, atol=1e-9)
  sub = t.get_correlation(var_names1=list(t.get_var_names()[:3]),
                          var_names2=list(t.get_var_names("proteomic")[:2]),
                          device=CPU)
  assert len(sub) == 6 and t.uns["transcriptomic_proteomic_correlation"] \
      is got


def test_mutual_information_as_jax(pair):
  j, t = (s.copy() for s in pair)
  want = j.get_mutual_information()
  got = t.get_mutual_information(device=CPU)
  assert list(got) == ["index"] + list(want.columns)
  np.testing.assert_array_equal(got["index"], want.index.values)
  for c in want.columns:
    np.testing.assert_allclose(got[c], want[c].values, rtol=0, atol=1e-9)
  # backend='jax' is ``ops.knn_mi`` on the subsampled cells (held to the
  # JAX function by test_torch_port_knn_mi; its jit here would cost 10 s)
  from sisua_tpu_torch.ops.knn_mi import knn_mutual_information
  got = t.get_mutual_information(backend="jax", max_cells=300, device=CPU)
  assert "transcriptomic_proteomic_mutualinfo_sub300" in t.uns
  sel = np.random.RandomState(8).permutation(600)[:300]
  mi = knn_mutual_information(t.numpy()[sel].astype(np.float64),
                              t.numpy("proteomic")[sel].astype(np.float64),
                              random_state=8, device=CPU)
  for k, c in enumerate(want.columns):
    np.testing.assert_array_equal(got[c], mi[:, k])


def test_importance_matrix_as_jax():
  from sisua_tpu.data import generate_synthetic as jgen
  from sisua_tpu_torch.data import generate_synthetic as tgen
  kw = dict(n_cells=200, n_genes=20, n_proteins=2, n_celltypes=3, seed=5218)
  j, t = jgen(**kw), tgen(**kw)
  for n_trees, seed in ((4, 8), (30, 3)):
    j.uns.clear()
    t.uns.clear()
    want = j.get_importance_matrix(n_estimators=n_trees, random_state=seed)
    got = t.get_importance_matrix(n_estimators=n_trees, random_state=seed)
    assert list(got) == ["index"] + list(want.columns)
    for c in want.columns:
      np.testing.assert_allclose(got[c], want[c].values, rtol=0, atol=1e-9)


def test_random_forest_regressor_as_sklearn():
  """The forest itself: importances and predictions of sklearn's
  ``RandomForestRegressor`` at depth 3 and at the analyzer's 8, on
  features without exact ties (among exactly equal float32 values of a
  node the builder keeps the row order where sklearn's introsort keeps
  its own, ``estimators._TreeBuilder``)."""
  from sklearn.ensemble import RandomForestRegressor as SK

  from sisua_tpu_torch.analysis.estimators import RandomForestRegressor
  rng = np.random.default_rng(4)
  X = rng.normal(size=(150, 6)).astype(np.float32)
  y = X[:, 0] * 2 - X[:, 3] + rng.normal(size=150)
  for depth in (3, 8):
    sk = SK(n_estimators=5, max_depth=depth, random_state=11).fit(X, y)
    port = RandomForestRegressor(5, depth, random_state=11).fit(X, y)
    np.testing.assert_allclose(port.feature_importances_,
                               sk.feature_importances_, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.predict(X), sk.predict(X), rtol=0,
                               atol=1e-12)

"""_OMICanalyzer: the JAX data analyzer (port of
``sisua_tpu/data/analysis.py``), mixed into the port's ``SingleCellOMIC``.

The filters, normalizations, QC metrics, PCA, UMAP, neighbours,
clusterings, rank tests, correlations and mutual information run as torch
operations on ``device`` (default ``'cuda'``, which must exist; every
method takes ``device='cpu'`` on request), on the port's counterparts of
the sklearn and scipy pieces the JAX analyzer calls
(``analysis/{decomposition,cluster,stats,estimators}.py``,
``data/umap_impl.py``). What the JAX analyzer does on the host with
numpy on small per-variable vectors (binning the dispersions, sorting
scores) is done here the same way on the host, and so are the steps the
JAX analyzer's libraries run sequentially there: Louvain's local moves,
Ward's merge tree, ARPACK and the random forest's trees.

Caches, keys and ``history`` entries are the JAX analyzer's: embeddings
in ``obsm['<omic>_pca' | '_umap']``, cluster ids in
``obs['<omic>_<algo><k>_r<seed>']``, graphs and tables in ``uns``. A
pandas DataFrame of the JAX analyzer is a ``{column: array}`` dict here,
in its column order, with its index of var names under ``'index'``.
t-SNE is not ported (ROADMAP A23b): ``dimension_reduce('tsne')`` raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse

__all__ = ["_OMICanalyzer", "diagonal_linear_assignment", "BATCH_SIZE"]

BATCH_SIZE = 4096  # rows above which PCA is incremental, and its batch

_TSNE_REFUSED = (
    "dimension_reduce(algo='tsne') is not ported: sklearn's t-SNE is "
    "Barnes-Hut, whose quadtree the port has no counterpart of yet "
    "(ROADMAP A23b); use algo='pca' or 'umap'")


def diagonal_linear_assignment(cm: np.ndarray) -> np.ndarray:
  """Hungarian matching of predicted → true cluster ids that makes the
  confusion matrix most diagonal (scipy's ``linear_sum_assignment``)."""
  from scipy.optimize import linear_sum_assignment
  r, c = linear_sum_assignment(-cm)
  mapping = np.arange(cm.shape[0])
  mapping[r] = c
  return mapping


def _dense(x) -> np.ndarray:
  if sparse.issparse(x):
    return np.asarray(x.todense(), dtype=np.float32)
  return np.asarray(x, dtype=np.float32)


def _dev(device) -> torch.device:
  from ..models.base import resolve_device
  return resolve_device(device)


def _median32(v: torch.Tensor) -> torch.Tensor:
  """numpy's ``median`` of a float32 vector: the middle value, or the
  float32 mean of the two middle ones."""
  s = torch.sort(v).values
  n = s.numel()
  if n % 2:
    return s[n // 2]
  return (s[n // 2 - 1] + s[n // 2]) / 2


def _sum32(X: torch.Tensor, dim: int) -> torch.Tensor:
  """A float32 sum, accumulated in float64 (exact for counts)."""
  return X.sum(dim, dtype=torch.float64).to(torch.float32)


def _colmean32(X: torch.Tensor) -> torch.Tensor:
  """numpy's float32 ``X.mean(0)``."""
  from ..analysis.stats import divide
  return divide(_colsum32(X), X.shape[0])


def _colvar32(X: torch.Tensor) -> torch.Tensor:
  """numpy's float32 ``X.var(0)``: the squared deviations from the float32
  column means, summed as ``_colsum32`` sums, over n."""
  from ..analysis.stats import divide
  dev = X - _colmean32(X)
  return divide(_colsum32(dev * dev), X.shape[0])


def _colsum32(X: torch.Tensor) -> torch.Tensor:
  from ..analysis.stats import column_sum
  return column_sum(X)


def _host(t: torch.Tensor) -> np.ndarray:
  return t.detach().cpu().numpy()


class _OMICanalyzer:
  """The analysis methods of ``SingleCellOMIC`` (see the module
  docstring)."""

  # ---------------------------------------------------------------- caches
  def _invalidate_analysis_caches(self, omic: Optional[str] = None,
                                  rows_only: bool = False):
    """Drop the derived caches a mutation made stale (all omics when
    ``omic`` is None): everything derived from the omic after a change of
    its values or columns; only the population tables and graphs after a
    row selection (sliced per-cell artifacts stay valid)."""
    def hit(key) -> bool:
      return omic is None or omic in str(key)
    population = ("_neighbors", "_correlation", "_importance",
                  "_mutualinfo", "_rank_")
    derived = population + ("_pca", "_tsne", "_umap", "_prob", "_bin")
    tags = population if rows_only else derived
    for store in (self.uns, self.obsm):
      for k in [k for k in list(store)
                if hit(k) and any(t in str(k) for t in tags)]:
        del store[k]
    if not rows_only:
      cluster_tags = ("_kmeans", "_knn", "_agglo", "_spectral", "_gmm",
                      "_louvain")
      for c in [c for c in list(self.obs)
                if hit(c) and any(t in str(c) for t in cluster_tags)]:
        del self.obs[c]

  def _tensor(self, omic, dev) -> torch.Tensor:
    return torch.as_tensor(self.numpy(omic), device=dev)

  # ------------------------------------------------------------- filtering
  def filter_highly_variable_genes(self,
                                   min_disp: float = 0.5,
                                   max_disp: float = np.inf,
                                   min_mean: float = 0.0125,
                                   max_mean: float = 3.0,
                                   n_top_genes: Optional[int] = None,
                                   n_bins: int = 20,
                                   flavor: str = "seurat",
                                   inplace: bool = True,
                                   device="cuda"):
    """Seurat / cell_ranger HVG selection: per-gene mean and dispersion of
    the counts normalized to the median total (log space for 'seurat'),
    dispersions normalized within 20 mean bins, then thresholds or the
    top ``n_top_genes``. The matrix passes run on ``device``; the binning
    is the JAX analyzer's numpy on the per-gene vectors."""
    obj = self if inplace else self.copy()
    X = torch.as_tensor(_dense(obj.X), device=_dev(device))
    sums = _sum32(X, 1)
    totals = torch.where(sums == 0, torch.ones_like(sums), sums)
    Xn = X / totals[:, None] * _median32(sums)
    if flavor == "seurat":
      mean = _host(torch.expm1(_colmean32(torch.log1p(Xn))))
    else:
      mean = _host(_colmean32(Xn))
    var = _host(_colvar32(Xn))
    del X, Xn
    if flavor == "seurat":
      disp = np.where(mean > 0, var / np.maximum(mean, 1e-12), 0.0)
      log_disp = np.log(disp + 1e-12)
      bins = np.quantile(mean, np.linspace(0, 1, n_bins + 1))
      bins[-1] += 1e-6
      bin_id = np.clip(np.digitize(mean, bins) - 1, 0, n_bins - 1)
      dispersions = np.zeros_like(log_disp)
      for b in range(n_bins):
        m = bin_id == b
        if m.sum() > 1:
          mu, sd = log_disp[m].mean(), log_disp[m].std()
          dispersions[m] = (log_disp[m] - mu) / (sd + 1e-12)
    else:
      disp = var / np.maximum(mean, 1e-12)
      log_disp = np.log1p(disp)
      bins = np.quantile(mean, np.linspace(0, 1, n_bins + 1))
      bins[-1] += 1e-6
      bin_id = np.clip(np.digitize(mean, bins) - 1, 0, n_bins - 1)
      dispersions = np.zeros_like(log_disp)
      for b in range(n_bins):
        m = bin_id == b
        if m.sum() > 1:
          med = np.median(log_disp[m])
          mad = np.median(np.abs(log_disp[m] - med)) + 1e-12
          dispersions[m] = (log_disp[m] - med) / mad
    if n_top_genes is not None:
      keep = np.zeros(len(mean), bool)
      keep[np.argsort(-dispersions)[:n_top_genes]] = True
    else:
      keep = ((dispersions >= min_disp) & (dispersions <= max_disp) &
              (mean >= min_mean) & (mean <= max_mean))
    obj.var["highly_variable"] = keep
    obj.var["means"] = mean
    obj.var["dispersions_norm"] = dispersions
    obj.apply_indices(np.nonzero(keep)[0], observation=False)
    obj._record("filter_highly_variable_genes",
                dict(n_top_genes=n_top_genes, flavor=flavor,
                     kept=int(keep.sum())))
    return obj

  def _count_filter(self, axis: int, bounds, device):
    X = torch.as_tensor(_dense(self.X), device=_dev(device))
    counts = _host(X.sum(axis, dtype=torch.float64))
    hits = _host((X > 0).sum(axis))
    keep = np.ones(X.shape[1 - axis], bool)
    for value, lo, hi in ((counts, bounds[0], bounds[1]),
                          (hits, bounds[2], bounds[3])):
      if lo is not None:
        keep &= value >= lo
      if hi is not None:
        keep &= value <= hi
    return keep

  def filter_genes(self,
                   min_counts: Optional[int] = None,
                   max_counts: Optional[int] = None,
                   min_cells: Optional[int] = None,
                   max_cells: Optional[int] = None,
                   inplace: bool = True,
                   device="cuda"):
    """Keep the genes of the current omic within count and cell bounds."""
    obj = self if inplace else self.copy()
    keep = obj._count_filter(0, (min_counts, max_counts, min_cells,
                                 max_cells), device)
    obj.apply_indices(np.nonzero(keep)[0], observation=False)
    obj._record("filter_genes", dict(min_counts=min_counts,
                                     max_counts=max_counts,
                                     min_cells=min_cells, max_cells=max_cells,
                                     kept=int(keep.sum())))
    return obj

  def filter_cells(self,
                   min_counts: Optional[int] = None,
                   max_counts: Optional[int] = None,
                   min_genes: Optional[int] = None,
                   max_genes: Optional[int] = None,
                   inplace: bool = True,
                   device="cuda"):
    """Keep the cells within library-size bounds of the current omic;
    every omic's statistics are recomputed."""
    obj = self if inplace else self.copy()
    keep = obj._count_filter(1, (min_counts, max_counts, min_genes,
                                 max_genes), device)
    obj.apply_indices(np.nonzero(keep)[0], observation=True)
    for om in obj.omics:
      obj._calculate_statistics(om)
    obj._record("filter_cells", dict(min_counts=min_counts,
                                     max_counts=max_counts,
                                     min_genes=min_genes, max_genes=max_genes,
                                     kept=int(keep.sum())))
    return obj

  # ------------------------------------------------------------ normalize
  def normalize(self,
                omic=None,
                total: bool = False,
                log1p: bool = False,
                scale: bool = False,
                target_sum: Optional[float] = None,
                max_value: Optional[float] = None,
                inplace: bool = True,
                device="cuda"):
    """Total-count normalization (to ``target_sum``, default the median
    total), log1p, unit-variance scaling (clipped at ``max_value``); the
    omic becomes a dense float32 matrix."""
    obj = self if inplace else self.copy()
    names = obj._omic_names(omic)
    dev = _dev(device)
    for om in names:
      X = torch.as_tensor(_dense(obj._omics[om]), device=dev)
      if total:
        sums = _sum32(X, 1)
        counts = torch.where(sums == 0, torch.ones_like(sums), sums)
        tsum = target_sum or float(_median32(sums))
        X = X / counts[:, None] * tsum
      if log1p:
        X = torch.log1p(X)
      if scale:
        mu = _colmean32(X)
        sd = torch.sqrt(_colvar32(X))
        sd = torch.where(sd == 0, torch.ones_like(sd), sd)
        X = (X - mu) / sd
        if max_value is not None:
          X = torch.clamp(X, -max_value, max_value)
      obj._omics[om] = np.ascontiguousarray(_host(X), np.float32)
      obj._calculate_statistics(om)
      obj._invalidate_analysis_caches(om)
    obj._record("normalize", dict(omic="_".join(names), total=total,
                                  log1p=log1p, scale=scale,
                                  target_sum=target_sum))
    return obj

  def expm1(self, omic=None, inplace: bool = True, device="cuda"):
    obj = self if inplace else self.copy()
    names = obj._omic_names(omic)
    for om in names:
      X = torch.as_tensor(_dense(obj._omics[om]), device=_dev(device))
      obj._omics[om] = _host(torch.expm1(X))
      obj._calculate_statistics(om)
      obj._invalidate_analysis_caches(om)
    obj._record("expm1", dict(omic="_".join(names)))
    return obj

  # ------------------------------------------------------------ embeddings
  def get_x_probs(self, omic=None, device="cuda") -> np.ndarray:
    """The probability embedding of an omic."""
    return self.probabilistic_embedding(omic=omic, device=device)[1]

  def get_x_bins(self, omic=None, device="cuda") -> np.ndarray:
    """The binary embedding of an omic."""
    return self.probabilistic_embedding(omic=omic, device=device)[2]

  def probabilistic_embedding(self,
                              omic=None,
                              n_components_per_class: int = 2,
                              positive_component: int = 1,
                              log_norm: bool = True,
                              clip_quartile: float = 0.0,
                              remove_zeros: bool = True,
                              ci_threshold: float = -0.68,
                              seed: int = 8,
                              device="cuda"):
    """Per-feature GMM probabilization (``ProbabilisticEmbedding``,
    fitted on ``device``): the model in ``uns['<omic>_prob_embedding_…']``
    and ``(model, probabilities, binary)``; every key carries every
    parameter."""
    from ..label_threshold import ProbabilisticEmbedding
    omic = self._one(omic)
    params = (n_components_per_class, positive_component, log_norm,
              clip_quartile, remove_zeros, ci_threshold, seed)
    suffix = "_" + "_".join(f"{p:g}" if isinstance(p, float) else str(int(p))
                            for p in params)
    key = f"{omic}_prob_embedding{suffix}"
    k_prob, k_bin = f"{omic}_prob{suffix}", f"{omic}_bin{suffix}"
    if key not in self.uns:
      X = self.numpy(omic)
      pe = ProbabilisticEmbedding(
          n_components_per_class=n_components_per_class,
          positive_component=positive_component, log_norm=log_norm,
          clip_quartile=clip_quartile, remove_zeros=remove_zeros,
          ci_threshold=ci_threshold, random_state=seed, device=device)
      pe.fit(X)
      self.uns[key] = pe
      self.obsm[k_prob] = pe.predict_proba(X)
      self.obsm[k_bin] = pe.predict(X)
      self._record("probabilistic_embedding", dict(omic=omic, seed=seed))
    return (self.uns[key], self.obsm[k_prob], self.obsm[k_bin])

  def dimension_reduce(self,
                       omic=None,
                       n_components: int = 100,
                       algo: str = "pca",
                       random_state: int = 8,
                       device="cuda") -> np.ndarray:
    """PCA (incremental above ``BATCH_SIZE`` rows) or UMAP embedding,
    cached in ``obsm['<omic>_<algo>']``; a wider request recomputes.
    UMAP runs on the first 50 PCs of a wider omic."""
    omic = self._one(omic)
    algo = str(algo).lower()
    if algo == "tsne":
      raise NotImplementedError(_TSNE_REFUSED)
    if algo not in ("pca", "umap"):
      raise ValueError(f"Unknown algo '{algo}' (pca|tsne|umap)")
    key = f"{omic}_{algo}"
    if key in self.obsm:
      cached = self.obsm[key]
      if cached.shape[1] >= n_components:
        return cached[:, :n_components]
      del self.obsm[key]
      n_components = max(n_components, cached.shape[1])
    X = self.numpy(omic)
    n_components = min(n_components, X.shape[1], X.shape[0])
    if algo == "pca":
      from ..analysis.decomposition import PCA, IncrementalPCA
      if X.shape[0] > BATCH_SIZE:
        model = IncrementalPCA(n_components=n_components,
                               batch_size=BATCH_SIZE, device=device)
      else:
        model = PCA(n_components=n_components, random_state=random_state,
                    device=device)
      emb = _host(model.fit_transform(X))
      self.uns[f"{key}_model"] = model
    else:
      from .umap_impl import fit_umap
      nc = max(2, min(n_components, 3))
      feats = X
      if X.shape[1] > 50:
        feats = self.dimension_reduce(omic, n_components=50, algo="pca",
                                      random_state=random_state,
                                      device=device)
      emb = fit_umap(feats, n_components=nc, random_state=random_state,
                     device=device)
    self.obsm[key] = np.asarray(emb, np.float32)
    self._record("dimension_reduce", dict(omic=omic, algo=algo,
                                          n_components=n_components))
    return self.obsm[key]

  def neighbors(self,
                omic=None,
                n_neighbors: int = 12,
                n_pcs: int = 100,
                random_state: int = 8,
                device="cuda"):
    """The kNN graph of the PCA embedding: ``{'distances',
    'connectivities'}`` as CSR matrices (each row's own entry included,
    at distance 0) and ``n_neighbors``."""
    from ..analysis.cluster import kneighbors
    omic = self._one(omic)
    key = f"{omic}_neighbors_k{int(n_neighbors)}_p{int(n_pcs)}"
    if key in self.uns:
      return self.uns[key]
    pca = self.dimension_reduce(omic, n_components=n_pcs, algo="pca",
                                random_state=random_state, device=device)
    dist, idx = kneighbors(pca, n_neighbors, device=device)
    dist, idx = _host(dist).ravel(), _host(idx).ravel()
    n = pca.shape[0]
    indptr = np.arange(0, n * n_neighbors + 1, n_neighbors)
    self.uns[key] = {
        "distances": sparse.csr_matrix((dist, idx, indptr), shape=(n, n)),
        "connectivities": sparse.csr_matrix((np.ones(len(idx)), idx, indptr),
                                            shape=(n, n)),
        "n_neighbors": n_neighbors}
    self._record("neighbors", dict(omic=omic, n_neighbors=n_neighbors))
    return self.uns[key]

  # ------------------------------------------------------------- clustering
  def _label_omic(self) -> Optional[str]:
    for cand in ("celltype", "disease", "progenitor", "tissue"):
      if cand in self.omics:
        return cand
    return None

  def clustering(self,
                 omic=None,
                 n_clusters: Optional[int] = None,
                 algo: str = "kmeans",
                 matching_labels: Optional[str] = None,
                 random_state: int = 8,
                 return_key: bool = False,
                 device="cuda"):
    """KMeans / agglomerative ('knn', 'agglo') / spectral / gmm cluster
    ids of the PCA embedding, cached in ``obs``; with
    ``matching_labels``, matched to that label omic's classes by the
    Hungarian method."""
    from ..analysis import cluster as C
    from ..analysis.estimators import GaussianMixture, KMeans
    omic = self._one(omic)
    if n_clusters is None:
      lab = self._label_omic()
      n_clusters = self.get_dim(lab) if lab is not None else 8
    algo = str(algo).lower()
    key = f"{omic}_{algo}{n_clusters}_r{int(random_state)}"
    if matching_labels is not None:
      key += f"_m{self._one(matching_labels)}"
    if key in self.obs:
      return key if return_key else self.obs[key]
    X = self.dimension_reduce(omic, n_components=min(100, self.get_dim(omic)),
                              algo="pca", random_state=random_state,
                              device=device)
    if algo == "kmeans":
      ids = KMeans(n_clusters=n_clusters, n_init=10,
                   random_state=random_state, device=device).fit_predict(X)
    elif algo in ("knn", "agglo", "agglomerative"):
      ids = C.AgglomerativeClustering(n_clusters=n_clusters).fit_predict(X)
    elif algo == "spectral":
      ids = C.SpectralClustering(n_clusters=n_clusters,
                                 random_state=random_state,
                                 device=device).fit_predict(X)
    elif algo == "gmm":
      ids = GaussianMixture(n_components=n_clusters,
                            random_state=random_state,
                            device=device).fit_predict(X)
    else:
      raise ValueError(f"Unknown clustering algo: {algo}")
    ids = _host(ids) if isinstance(ids, torch.Tensor) else np.asarray(ids)
    if matching_labels is not None:
      true = np.argmax(self.numpy(matching_labels), axis=1)
      cm = np.zeros((n_clusters, max(n_clusters, true.max() + 1)))
      np.add.at(cm, (ids, true), 1)
      ids = diagonal_linear_assignment(cm)[ids]
    self.obs[key] = ids
    self._record("clustering", dict(omic=omic, algo=algo,
                                    n_clusters=n_clusters))
    return key if return_key else ids

  def louvain(self,
              omic=None,
              resolution: float = 1.0,
              n_neighbors: int = 12,
              random_state: int = 8,
              return_key: bool = False,
              device="cuda"):
    """Louvain communities of the kNN connectivity graph (greedy
    modularity, local moves then aggregation, on the host)."""
    omic = self._one(omic)
    key = f"{omic}_louvain_res{resolution:g}_k{int(n_neighbors)}"
    if key in self.obs:
      return key if return_key else self.obs[key]
    graph = self.neighbors(omic, n_neighbors=n_neighbors,
                           random_state=random_state,
                           device=device)["connectivities"]
    ids = _louvain_communities(graph, resolution=resolution,
                               seed=random_state)
    self.obs[key] = ids
    self._record("louvain", dict(omic=omic, resolution=resolution))
    return key if return_key else ids

  # ------------------------------------------------------------------ stats
  def top_vars(self, omic=None, n_vars: int = 100,
               device="cuda") -> np.ndarray:
    """The names of the highest-variance variables."""
    var = _host(_colvar32(self._tensor(omic, _dev(device))))
    return self.get_var_names(omic)[np.argsort(-var)[:n_vars]]

  def rank_vars_groups(self,
                       omic=None,
                       group_omic="celltype",
                       n_vars: int = 100,
                       method: str = "t-test",
                       device="cuda") -> Dict[str, Dict[str, np.ndarray]]:
    """Variables ranked per label group, each group against the rest, by
    Welch's t ('t-test') or the Mann-Whitney U (any other ``method``):
    ``{group: {'names', 'scores', 'pvals'}}`` of the top ``n_vars``."""
    from ..analysis import stats
    omic = self._one(omic)
    group_omic = self._one(group_omic)
    dev = _dev(device)
    X = self._tensor(omic, dev)
    labels = np.argmax(self.numpy(group_omic), axis=1)
    names = self.get_var_names(omic)
    group_names = self.get_var_names(group_omic)
    ranks = None
    out = {}
    for g in np.unique(labels):
      in_g = labels == g
      if in_g.sum() < 2 or (~in_g).sum() < 2:
        continue
      if method == "t-test":
        score, pval = stats.welch_ttest(X, in_g, device=dev)
      else:
        if ranks is None:
          ranks = stats.average_ranks(X.to(torch.float64))
        score, pval = stats.mannwhitneyu(X, in_g, device=dev, ranks=ranks)
      score = np.nan_to_num(score)
      order = np.argsort(-score)[:n_vars]
      out[str(group_names[g])] = {"names": names[order],
                                  "scores": score[order],
                                  "pvals": np.asarray(pval)[order]}
    self.uns[f"{omic}_rank_{group_omic}"] = out
    return out

  def calculate_quality_metrics(self, omic=None, device="cuda"):
    """Per-cell (``<omic>_n_vars_by_counts``, ``_total_counts``,
    ``_pct_counts_in_top_50_vars``) and per-variable
    (``n_cells_by_counts``, ``total_counts``, ``mean_counts``,
    ``pct_dropout_by_counts``) QC metrics, in ``obs`` and the var table."""
    omic = self._one(omic)
    X = self._tensor(omic, _dev(device))
    nz = X > 0
    total = _sum32(X, 1)
    self.obs[f"{omic}_n_vars_by_counts"] = _host(nz.sum(1))
    self.obs[f"{omic}_total_counts"] = _host(total)
    totals = torch.where(total == 0, torch.ones_like(total), total)
    top = torch.topk(X, min(50, X.shape[1]), dim=1).values
    self.obs[f"{omic}_pct_counts_in_top_50_vars"] = _host(
        100.0 * _sum32(top, 1) / totals)
    v = self.get_var(omic)
    v["n_cells_by_counts"] = _host(nz.sum(0))
    v["total_counts"] = _host(_colsum32(X))
    v["mean_counts"] = _host(_colmean32(X))
    v["pct_dropout_by_counts"] = 100.0 * (
        1.0 - _host(nz.sum(0, dtype=torch.float64)) / X.shape[0])
    self._record("calculate_quality_metrics", dict(omic=omic))
    return self

  def get_marker_pairs(self,
                       omic1="transcriptomic",
                       omic2="proteomic",
                       var_names1: Optional[Sequence[str]] = None,
                       var_names2: Optional[Sequence[str]] = None,
                       remove_duplicated: bool = True
                       ) -> List[Tuple[str, str]]:
    """The known (gene, protein) marker pairs present in both omics
    (within ``var_names1``/``var_names2`` when given)."""
    from .const import marker_pairs
    omic1, omic2 = self._one(omic1), self._one(omic2)
    pairs = marker_pairs(omic1, omic2)
    if pairs is None:
      return []
    names1 = set(map(str, self.get_var_names(omic1)))
    names2 = set(map(str, self.get_var_names(omic2)))
    if var_names1 is not None:
      names1 &= set(map(str, var_names1))
    if var_names2 is not None:
      names2 &= set(map(str, var_names2))
    out = [(a, b) for a, b in pairs if a in names1 and b in names2]
    if remove_duplicated:
      out = list(dict.fromkeys(out))
    return out

  def get_importance_matrix(self, omic1=None, omic2="proteomic",
                            n_estimators: int = 80,
                            random_state: int = 8,
                            ncpu: int = 1) -> Dict[str, np.ndarray]:
    """Random-forest importance of each omic1 variable for predicting
    each omic2 variable: ``{'index': omic1 names, <omic2 name>:
    importances}``. Forests of ``max_depth`` 8 are grown as 20-tree
    chunks seeded ``random_state + 1000·chunk`` (the chunk is the unit of
    randomness, so every ``ncpu`` gives the same bits; ``ncpu`` > 1
    spawns processes for the (column, chunk) tasks). The trees grow on
    the host."""
    from ..utils import mpi_map
    omic1 = self._one(omic1)
    omic2 = self._one(omic2)
    key = f"{omic1}_{omic2}_importance"
    if key in self.uns:
      return self.uns[key]
    X = self.numpy(omic1)
    Y = self.numpy(omic2)
    names2 = [str(n) for n in self.get_var_names(omic2)]
    chunk_trees = 20
    n_chunks = max(1, -(-n_estimators // chunk_trees))
    per = n_estimators // n_chunks
    sizes = [per + (c < n_estimators % n_chunks) for c in range(n_chunks)]
    tasks = [(j, c) for j in range(len(names2))
             for c in range(n_chunks) if sizes[c]]
    parts = mpi_map(_forest_importances,
                    [(X, Y[:, j], sizes[c], random_state + 1000 * c)
                     for j, c in tasks], ncpu=ncpu)
    cols = {name: np.zeros(X.shape[1]) for name in names2}
    total = float(sum(sizes))
    for (j, c), imp in zip(tasks, parts):
      cols[names2[j]] += imp * (sizes[c] / total)
    self.uns[key] = {"index": self.get_var_names(omic1), **cols}
    return self.uns[key]

  def get_mutual_information(self, omic1=None, omic2="proteomic",
                             n_neighbors: int = 3,
                             random_state: int = 8,
                             ncpu: int = 1,
                             backend: str = "sklearn",
                             max_cells: Optional[int] = None,
                             device="cuda") -> Dict[str, np.ndarray]:
    """Kraskov kNN mutual information between every pair of omic1 and
    omic2 variables, ``{'index': omic1 names, <omic2 name>: nats}``, in
    float64. ``backend='sklearn'``: sklearn's ``mutual_info_regression``
    per omic2 variable over 512-column blocks of omic1 seeded
    ``random_state + block`` (``stats.mutual_info_regression`` on
    ``device``); ``'jax'``: the whole matrix at once (``ops.knn_mi``).
    ``max_cells`` subsamples the cells by a seeded permutation first and
    keys the cache apart. ``ncpu`` is the JAX signature's: the port's
    blocks run on the device one after another."""
    from ..analysis.stats import mutual_info_regression
    omic1 = self._one(omic1)
    omic2 = self._one(omic2)
    key = f"{omic1}_{omic2}_mutualinfo" \
        + (f"_sub{int(max_cells)}" if max_cells is not None else "")
    if key in self.uns:
      return self.uns[key]
    X = np.asarray(self.numpy(omic1), np.float64)
    Y = np.asarray(self.numpy(omic2), np.float64)
    if max_cells is not None and X.shape[0] > max_cells:
      sel = np.random.RandomState(random_state).permutation(
          X.shape[0])[:max_cells]
      X, Y = X[sel], Y[sel]
    names2 = [str(n) for n in self.get_var_names(omic2)]
    if backend == "jax":
      from ..ops.knn_mi import knn_mutual_information
      mi = knn_mutual_information(X, Y, n_neighbors=n_neighbors,
                                  random_state=random_state, device=device)
      cols = dict(zip(names2, mi.T))
    else:
      n1 = X.shape[1]
      bounds = list(range(0, n1, 512)) + [n1]
      cols = {name: np.zeros(n1) for name in names2}
      for j, name in enumerate(names2):
        for c in range(len(bounds) - 1):
          lo, hi = bounds[c], bounds[c + 1]
          cols[name][lo:hi] = mutual_info_regression(
              X[:, lo:hi], Y[:, j], n_neighbors=n_neighbors,
              random_state=random_state + c, device=device)
    self.uns[key] = {"index": self.get_var_names(omic1), **cols}
    return self.uns[key]

  def get_correlation(self, omic1=None, omic2="proteomic",
                      var_names1: Optional[Sequence[str]] = None,
                      var_names2: Optional[Sequence[str]] = None,
                      device="cuda") -> List[Tuple[int, int, float, float]]:
    """Pearson and Spearman correlation of every (or the named) omic1 ×
    omic2 variable pair: ``[(idx1, idx2, pearson, spearman)]`` sorted by
    |spearman| descending; cached when unrestricted."""
    from ..analysis.stats import correlations
    omic1 = self._one(omic1)
    omic2 = self._one(omic2)
    key = f"{omic1}_{omic2}_correlation"
    if key in self.uns and var_names1 is None and var_names2 is None:
      return self.uns[key]
    X = self.numpy(omic1)
    Y = self.numpy(omic2)
    idx1 = (np.arange(X.shape[1]) if var_names1 is None else
            [self.get_var_indices(omic1)[v] for v in var_names1])
    idx2 = (np.arange(Y.shape[1]) if var_names2 is None else
            [self.get_var_indices(omic2)[v] for v in var_names2])
    pear, spear = correlations(X[:, idx1], Y[:, idx2], device=device)
    out = [(int(i1), int(i2), float(pear[a, b]), float(spear[a, b]))
           for a, i1 in enumerate(idx1) for b, i2 in enumerate(idx2)]
    out.sort(key=lambda t: -abs(t[3]))
    if var_names1 is None and var_names2 is None:
      self.uns[key] = out
    return out


def _forest_importances(task) -> np.ndarray:
  """One chunk of ``get_importance_matrix``: (X, y, trees, seed) → the
  forest's feature importances (a module-level function, for spawned
  workers)."""
  from ..analysis.estimators import RandomForestRegressor
  X, y, n_trees, seed = task
  return RandomForestRegressor(n_estimators=n_trees, max_depth=8,
                               random_state=seed).fit(X, y
                                                      ).feature_importances_


# ---------------------------------------------------------------------------
# Louvain (greedy modularity on a sparse graph), the JAX analyzer's
# ---------------------------------------------------------------------------
def _louvain_communities(adj: sparse.spmatrix, resolution: float = 1.0,
                         seed: int = 8, max_passes: int = 5) -> np.ndarray:
  """One-pass-per-level Louvain on a symmetric weighted graph."""
  adj = (adj + adj.T) * 0.5
  adj = adj.tocsr()
  n = adj.shape[0]
  g = adj
  mapping = np.arange(n)
  rng = np.random.RandomState(seed)
  for _ in range(max_passes):
    labels, improved = _louvain_one_level(g, resolution, rng)
    mapping = labels[mapping]
    if not improved:
      break
    prev_nodes = g.shape[0]
    k = labels.max() + 1
    rows = labels[np.repeat(np.arange(g.shape[0]), np.diff(g.indptr))]
    cols = labels[g.indices]
    g = sparse.coo_matrix((g.data, (rows, cols)), shape=(k, k)).tocsr()
    g.sum_duplicates()
    # converged when aggregation stopped shrinking the graph or merged
    # everything into one community
    if k >= prev_nodes or k <= 1:
      break
  _, out = np.unique(mapping, return_inverse=True)
  return out.astype(np.int64)


def _louvain_one_level(g: sparse.csr_matrix, resolution: float,
                       rng: np.random.RandomState):
  n = g.shape[0]
  labels = np.arange(n)
  degrees = np.asarray(g.sum(1)).ravel()
  m2 = degrees.sum()  # = 2m
  if m2 == 0:
    return labels, False
  com_deg = degrees.copy()
  improved_any = False
  order = rng.permutation(n)
  indptr, indices, data = g.indptr, g.indices, g.data
  for _ in range(10):  # local-move sweeps
    moved = 0
    for i in order:
      ci = labels[i]
      lo, hi = indptr[i], indptr[i + 1]
      com_deg[ci] -= degrees[i]
      com_w: Dict[int, float] = {}
      for jx, wx in zip(indices[lo:hi], data[lo:hi]):
        if jx == i:
          continue
        cj = labels[jx]
        com_w[cj] = com_w.get(cj, 0.0) + wx
      best_c, best_gain = ci, 0.0
      base = com_w.get(ci, 0.0) - resolution * com_deg[ci] * degrees[i] / m2
      for cj, wx in com_w.items():
        gain = wx - resolution * com_deg[cj] * degrees[i] / m2
        if gain - base > best_gain + 1e-12:
          best_gain = gain - base
          best_c = cj
      labels[i] = best_c
      com_deg[best_c] += degrees[i]
      if best_c != ci:
        moved += 1
        improved_any = True
    if moved == 0:
      break
  _, labels = np.unique(labels, return_inverse=True)
  return labels.astype(np.int64), improved_any

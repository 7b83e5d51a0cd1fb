"""_OMICvisualizer: the figure methods of the port's ``SingleCellOMIC``
(port of ``sisua_tpu/data/visualizer.py``).

Each method's data step resolves the labels and variables as the JAX
method does and computes what the figure draws in torch on ``device``
(default 'cuda'; 'cpu' on request): log1p, the group centroids and
fractions (in numpy's float32 order, ``analysis.stats.column_sum``),
min-max scaling, the one-vs-rest Welch t of the ranked panels, the
embeddings (the analyzer's ``dimension_reduce``, cached as the JAX
analyzer caches it), and the correlation, mutual-information and
importance matrices (the analyzer's, as arrays with their names). Ward's
linkage of the group centroids runs in scipy on the host, and so do the
sorts of small per-variable vectors, as ``np.argsort`` orders their ties.
The render step is the JAX drawing code (seaborn for the violins, over
the long-form arrays the JAX method melts with pandas). Within
``figure_data()`` only the data steps run (see ``utils.visualization``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.visualization import (Visualizer, _host, _pyplot, _seaborn,
                                   fast_scatter)
from .analysis import _OMICanalyzer, _dev
from .const import omic_markers

__all__ = ["_OMICvisualizer"]


def _omic(o) -> str:
  return str(o).lower().strip()


def _group_mean(x: torch.Tensor) -> torch.Tensor:
  """numpy's float32 ``x.mean(0)`` of a C-ordered matrix."""
  from ..analysis.stats import column_sum, divide
  return divide(column_sum(x), x.shape[0])


def _rows(labels: np.ndarray, u, dev) -> torch.Tensor:
  return torch.as_tensor(np.where(labels == u)[0], device=dev)


class _OMICvisualizer(_OMICanalyzer, Visualizer):

  # ------------------------------------------------------------- label reso
  def _process_omics(self, omic, clustering: Optional[str] = None,
                     device="cuda") -> Tuple[str, np.ndarray]:
    """(name, per-cell labels) of an obs column, a clustering of an omic,
    or an omic: one-hot → the var name of the argmax, binary → the '+'
    join of its positive names ('none'), else the argmax's name."""
    from .utils import is_binary_dtype, is_categorical_dtype
    if isinstance(omic, str) and omic in self.obs:
      return omic, self.obs[omic]
    name = _omic(omic)
    if clustering is not None:
      algo = str(clustering).lower()
      if algo == "louvain":
        key = self.louvain(name, return_key=True, device=device)
      else:
        key = self.clustering(name, algo=algo, return_key=True,
                              device=device)
      return key, self.obs[key]
    x = self.numpy(name)
    var_names = self.get_var_names(name)
    if is_categorical_dtype(x):
      return name, np.asarray(var_names)[np.argmax(x, -1)]
    if is_binary_dtype(x):
      lab = np.asarray(["+".join(np.asarray(var_names)[row > 0.5]) or "none"
                        for row in x])
      return name, lab
    return name, np.asarray(var_names)[np.argmax(x, -1)]

  # ------------------------------------------------------------ var helpers
  def _process_varnames(self, omic, var_names, default_n: int = 16,
                        device="cuda"):
    """'auto' → the omic's markers present (top-variance fallback); an int
    → the top-n highest-variance vars; None → markers, else all vars
    (top-variance when wide); a name → that var; a list → filtered to
    existing names."""
    omic = _omic(omic)
    names = [str(v) for v in self.get_var_names(omic)]
    name_set = set(names)
    markers = [m for m in (omic_markers(omic) or []) if m in name_set]
    if isinstance(var_names, str) and var_names == "auto":
      var_names = markers[:default_n] or list(
          self.top_vars(omic, default_n, device=device))
    elif isinstance(var_names, str):
      if var_names not in name_set:
        raise ValueError(f"var name {var_names!r} not in omic {omic}")
      var_names = [var_names]
    elif var_names is None:
      var_names = markers or (names if len(names) <= 50 else list(
          self.top_vars(omic, default_n, device=device)))
    elif isinstance(var_names, (int, np.integer)):
      var_names = list(self.top_vars(omic, int(var_names), device=device))
    else:
      var_names = [str(v) for v in var_names if str(v) in name_set]
    if len(var_names) == 0:
      raise ValueError(f"No valid var_names for omic {omic}")
    return omic, list(dict.fromkeys(map(str, var_names)))

  def _resolve_groups(self, group_by, clustering, groups, device="cuda"):
    """(key, per-cell labels, shown categories); ``groups`` filters the
    categories shown."""
    if group_by is None:
      labels = np.full(self.n_obs, "all")
      return None, labels, np.array(["all"])
    key, labels = self._process_omics(group_by, clustering=clustering,
                                      device=device)
    labels = np.asarray(labels).astype(str)
    uniq = np.unique(labels)
    if groups is not None:
      if isinstance(groups, (str, bytes)):
        groups = [groups]
      want = {str(g) for g in groups}
      uniq = np.array([u for u in uniq if u in want])
      if len(uniq) == 0:
        raise ValueError(f"None of groups={sorted(want)} found in {key}")
    return key, labels, uniq

  @staticmethod
  def _ranked_var_blocks(x, labels, uniq, n):
    """Per-group top-n discriminative columns (Welch t, one group against
    the rest, where ``x`` lies), ordered as ``np.argsort`` orders the
    negated scores."""
    from ..analysis.stats import welch_ttest
    blocks = []
    for u in uniq:
      in_g = labels == u
      if in_g.sum() < 2 or (~in_g).sum() < 2:
        m = _host(_group_mean(x[_rows(labels, u, x.device)]))
        blocks.append(list(np.argsort(-m)[:n]))
        continue
      score, _ = welch_ttest(x, in_g, device=x.device)
      blocks.append(list(np.argsort(-np.nan_to_num(score))[:n]))
    return blocks

  @staticmethod
  def _dendrogram_order(cent):
    """Ward-linkage leaf order over group centroids (scipy, host)."""
    from scipy.cluster import hierarchy
    cent = _host(cent)
    if len(cent) < 2:
      return np.arange(len(cent)), None
    link = hierarchy.linkage(cent, method="ward")
    order = hierarchy.dendrogram(link, no_plot=True)["leaves"]
    return np.asarray(order), link

  @staticmethod
  def _fig_desc(title, omic, key, *, nv=None, rank=0, log=True,
                dendrogram=False, swap_axes=False, scale=None, groups=None):
    """Unique figure name from the argument grid."""
    parts = [title, _omic(omic), str(key),
             None if nv is None else f"v{nv}",
             f"rank{rank}" if rank else None,
             "log" if log else "raw",
             "dendro" if dendrogram else None,
             "swap" if swap_axes else None,
             f"scale-{scale}" if scale else None,
             ("g" + "-".join(sorted(map(str, np.atleast_1d(groups)))))
             if groups is not None else None]
    return "_".join(p for p in parts if p)

  @staticmethod
  def _standard_scale(x: torch.Tensor, mode):
    """scanpy ``standard_scale``: min-max each var ('var') or cell
    ('obs')."""
    floor = torch.tensor(1e-12, dtype=x.dtype, device=x.device)
    if mode == "var":
      x = x - x.amin(0, keepdim=True)
      x = x / torch.maximum(x.amax(0, keepdim=True), floor)
    elif mode == "obs":
      x = x - x.amin(1, keepdim=True)
      x = x / torch.maximum(x.amax(1, keepdim=True), floor)
    return x

  def _select_vars(self, omic, var_names, rank_vars, full, labels, uniq,
                   device="cuda"):
    """Columns + per-group boundaries for the rank-genes panel layout."""
    names = np.asarray([str(v) for v in self.get_var_names(omic)])
    if rank_vars > 0:
      blocks = self._ranked_var_blocks(full, labels, uniq, rank_vars)
      cols, bounds = [], [0]
      for b in blocks:
        cols.extend(b)
        bounds.append(len(cols))
      return list(names[cols]), [int(c) for c in cols], bounds
    omic, var_list = self._process_varnames(omic, var_names, device=device)
    vi = self.get_var_indices(omic)
    return var_list, [vi[v] for v in var_list], None

  def _centroids(self, x: torch.Tensor, labels, uniq) -> torch.Tensor:
    return torch.stack([_group_mean(x[_rows(labels, u, x.device)])
                        for u in uniq])

  def _log_omic(self, omic, log: bool, dev) -> torch.Tensor:
    x = self._tensor(omic, dev)
    return torch.log1p(x) if log else x

  # ----------------------------------------------------------------- plots
  def plot_scatter(self,
                   X="transcriptomic",
                   color_by=None,
                   algo: str = "tsne",
                   clustering: Optional[str] = None,
                   dimension: int = 2,
                   ax=None,
                   fig_size=(8, 6),
                   title: Optional[str] = None,
                   device="cuda") -> "_OMICvisualizer":
    """2-D embedding scatter colored by a label omic."""
    omic = _omic(X)
    emb = self.dimension_reduce(omic, n_components=dimension, algo=algo,
                                device=device)
    labels = None
    if color_by is not None:
      _, labels = self._process_omics(color_by, clustering=clustering,
                                      device=device)
    name = title or f"{omic}_{algo}_scatter"
    data = dict(emb=np.asarray(emb[:, :2]), labels=labels, title=name,
                fig_size=fig_size)
    return self._draw(name, data, lambda **d: fast_scatter(
        d["emb"], labels=d["labels"], title=d["title"], ax=ax,
        fig_size=d["fig_size"]).get_figure())

  def plot_stacked_violins(self,
                           X="transcriptomic",
                           group_by="celltype",
                           groups=None,
                           var_names="auto",
                           clustering: Optional[str] = None,
                           rank_vars: int = 0,
                           rank_genes: int = 0,
                           dendrogram: bool = False,
                           standard_scale: Optional[str] = None,
                           log: bool = True,
                           swap_axes: bool = False,
                           title: str = "",
                           return_figure: bool = False,
                           device="cuda"):
    """Violin of vars per label group: ``rank_vars>0`` ranks vars per
    group, ``dendrogram`` orders groups by Ward linkage, ``groups``
    selects categories, ``standard_scale`` min-max scales, ``swap_axes``
    swaps var/group roles. The data step gives the long-form (group, var,
    value) arrays."""
    dev = _dev(device)
    rank_vars = max(int(rank_vars), int(rank_genes))
    omic = _omic(X)
    key, labels, uniq = self._resolve_groups(group_by, clustering, groups,
                                             device)
    full = self._log_omic(omic, log, dev)
    if dendrogram and len(uniq) > 1:
      order, _ = self._dendrogram_order(self._centroids(full, labels, uniq))
      uniq = uniq[order]
    var_list, cols, _ = self._select_vars(omic, var_names, rank_vars, full,
                                          labels, uniq, device)
    keep = np.isin(labels, uniq)
    kept = torch.as_tensor(np.where(keep)[0], device=dev)
    x = self._standard_scale(
        full[kept][:, torch.as_tensor(cols, device=dev)], standard_scale)
    # duplicated rank columns across groups collapse in the JAX frame;
    # the first of each name is kept
    first = {}
    for j, v in enumerate(var_list):
      first.setdefault(str(v), j)
    x = _host(x[:, torch.as_tensor(list(first.values()), device=dev)])
    n_keep = x.shape[0]
    desc = self._fig_desc(title, omic, key, nv=len(var_list), rank=rank_vars,
                          log=log, dendrogram=dendrogram,
                          swap_axes=swap_axes, scale=standard_scale,
                          groups=groups)
    data = dict(group=np.tile(labels[keep], len(first)),
                var=np.repeat(np.asarray(list(first), dtype=object), n_keep),
                value=x.T.ravel(), categories=list(uniq),
                n_vars=len(var_list), swap_axes=swap_axes, desc=desc)
    if return_figure:
      return data if self._data_only else _render_violins(**data)
    return self._draw(f"violin_{desc}", data, _render_violins)

  def plot_dotplot(self,
                   X="transcriptomic",
                   group_by="celltype",
                   groups=None,
                   var_names="auto",
                   clustering: Optional[str] = None,
                   rank_genes: int = 0,
                   rank_vars: int = 0,
                   dendrogram: bool = False,
                   standard_scale: Optional[str] = "var",
                   cmap: str = "Reds",
                   log: bool = True,
                   title: str = "",
                   return_figure: bool = False,
                   device="cuda"):
    """Dot plot: dot size = fraction of group expressing, color = (scaled)
    mean expression; the rank_genes_groups panel (``rank_genes>0``,
    per-group separators) and Ward-dendrogram group ordering drawn in a
    side panel."""
    dev = _dev(device)
    rank_vars = max(int(rank_vars), int(rank_genes))
    omic = _omic(X)
    key, labels, uniq = self._resolve_groups(group_by, clustering, groups,
                                             device)
    full = self._tensor(omic, dev)
    logged = torch.log1p(full) if log else full
    link = None
    if dendrogram and len(uniq) > 1:
      order, link = self._dendrogram_order(
          self._centroids(logged, labels, uniq))
      uniq = uniq[order]
    var_list, cols, bounds = self._select_vars(omic, var_names, rank_vars,
                                               logged, labels, uniq, device)
    c = torch.as_tensor(cols, device=dev)
    mean = torch.stack([_group_mean(logged[_rows(labels, u, dev)][:, c])
                        for u in uniq])
    frac = torch.stack([
        (full[_rows(labels, u, dev)][:, c] > 0).to(torch.float64).sum(0)
        / float((labels == u).sum()) for u in uniq])
    mean = self._standard_scale(mean, standard_scale)
    desc = self._fig_desc(title, omic, key, nv=len(var_list), rank=rank_vars,
                          log=log, dendrogram=dendrogram,
                          scale=standard_scale, groups=groups)
    data = dict(mean=_host(mean), frac=_host(frac), var_list=var_list,
                uniq=[str(u) for u in uniq], link=link, bounds=bounds,
                cmap=cmap, standard_scale=standard_scale, desc=desc)
    if return_figure:
      return data if self._data_only else _render_dotplot(**data)
    return self._draw(f"dotplot_{desc}", data, _render_dotplot)

  def plot_heatmap(self,
                   X="transcriptomic",
                   group_by="celltype",
                   groups=None,
                   var_names="auto",
                   clustering: Optional[str] = None,
                   rank_vars: int = 0,
                   rank_genes: int = 0,
                   dendrogram: bool = False,
                   swap_axes: bool = False,
                   cmap: str = "viridis",
                   standard_scale: Optional[str] = "var",
                   log: bool = True,
                   title: str = "",
                   return_figure: bool = False,
                   device="cuda"):
    """Cells×vars heatmap grouped by labels: ``rank_vars>0`` renders the
    rank_genes_groups_heatmap panel (per-group top discriminative vars
    with block separators), ``dendrogram`` orders groups by Ward linkage
    (drawn in a side panel), ``groups`` selects categories, plus
    ``standard_scale``/``swap_axes``/``cmap``/``return_figure``."""
    dev = _dev(device)
    rank_vars = max(int(rank_vars), int(rank_genes))
    omic = _omic(X)
    key, labels, uniq = self._resolve_groups(group_by, clustering, groups,
                                             device)
    full = self._log_omic(omic, log, dev)
    link = None
    if dendrogram and len(uniq) > 1:
      order, link = self._dendrogram_order(
          self._centroids(full, labels, uniq))
      uniq = uniq[order]
    var_list, cols, bounds = self._select_vars(omic, var_names, rank_vars,
                                               full, labels, uniq, device)
    x = self._standard_scale(full[:, torch.as_tensor(cols, device=dev)],
                             standard_scale)
    # cells sorted into group blocks in display order
    sel = np.concatenate([np.where(labels == u)[0] for u in uniq])
    x = _host(x[torch.as_tensor(sel, device=dev)])
    sizes = [int(np.sum(labels == u)) for u in uniq]
    desc = self._fig_desc(title, omic, key, nv=len(var_list), rank=rank_vars,
                          log=log, dendrogram=dendrogram,
                          swap_axes=swap_axes, scale=standard_scale,
                          groups=groups)
    data = dict(x=x, sizes=sizes, var_list=var_list,
                uniq=[str(u) for u in uniq], link=link, bounds=bounds,
                swap_axes=swap_axes, cmap=cmap, desc=desc)
    if return_figure:
      return data if self._data_only else _render_heatmap(**data)
    return self._draw(f"heatmap_{desc}", data, _render_heatmap)

  def plot_dendrogram_heatmap(self,
                              X="transcriptomic",
                              group_by="celltype",
                              var_names: Optional[Sequence[str]] = None,
                              log: bool = True,
                              device="cuda") -> "_OMICvisualizer":
    """Hierarchically-clustered group-mean heatmap with the dendrogram drawn
    above: groups ordered by Ward linkage over their centroid profiles."""
    from scipy.cluster import hierarchy
    dev = _dev(device)
    omic = _omic(X)
    if var_names is None:
      markers = omic_markers(omic) or []
      names = set(map(str, self.get_var_names(omic)))
      var_names = [m for m in markers if m in names][:25] or \
          list(self.top_vars(omic, 25, device=device))
    _, labels = self._process_omics(group_by, device=device)
    vi = self.get_var_indices(omic)
    x = self._tensor(omic, dev)[:, torch.as_tensor(
        [vi[str(v)] for v in var_names], device=dev)]
    if log:
      x = torch.log1p(x)
    uniq = np.unique(labels)
    cent = _host(self._centroids(x, labels, uniq))
    link, order = None, [0]
    if len(uniq) > 1:
      link = hierarchy.linkage(cent, method="ward")
      order = hierarchy.dendrogram(link, no_plot=True)["leaves"]
    data = dict(cent=cent, uniq=[str(u) for u in uniq], link=link,
                order=list(order), var_names=[str(v) for v in var_names])
    return self._draw(f"{omic}_dendrogram", data, _render_dendrogram_heatmap)

  def plot_distance_heatmap(self,
                            X="transcriptomic",
                            group_by="celltype",
                            metric: str = "euclidean",
                            device="cuda") -> "_OMICvisualizer":
    """Group-mean pairwise distance heatmap."""
    dev = _dev(device)
    omic = _omic(X)
    _, labels = self._process_omics(group_by, device=device)
    x = torch.log1p(self._tensor(omic, dev))
    uniq = np.unique(labels)
    cent = self._centroids(x, labels, uniq)
    data = dict(dm=_cdist(cent, metric), uniq=[str(u) for u in uniq])
    return self._draw(f"{omic}_distance_heatmap", data,
                      _render_distance_heatmap)

  def plot_importance_matrix(self, omic1="transcriptomic",
                             omic2="proteomic",
                             device="cuda") -> "_OMICvisualizer":
    table = self.get_importance_matrix(omic1, omic2)
    self._matrix_fig(_table_arrays(table), f"{_omic(omic1)}_importance",
                     top_rows=30)
    return self

  def plot_mutual_information(self, omic1="transcriptomic",
                              omic2="proteomic",
                              device="cuda") -> "_OMICvisualizer":
    table = self.get_mutual_information(omic1, omic2, device=device)
    self._matrix_fig(_table_arrays(table),
                     f"{_omic(omic1)}_mutual_information", top_rows=30)
    return self

  def _corr_matrix_df(self, omic1, omic2, which: str, device="cuda"):
    """The (omic1 × omic2) Pearson or Spearman matrix as (values, row
    names, column names)."""
    omic1, omic2 = _omic(omic1), _omic(omic2)
    corr = self.get_correlation(omic1, omic2, device=device)
    m = np.zeros((self.get_dim(omic1), self.get_dim(omic2)))
    col = 2 if which == "pearson" else 3
    for t in corr:
      m[t[0], t[1]] = t[col]
    return (m, [str(v) for v in self.get_var_names(omic1)],
            [str(v) for v in self.get_var_names(omic2)])

  def plot_pearson_matrix(self, omic1="transcriptomic", omic2="proteomic",
                          device="cuda") -> "_OMICvisualizer":
    m = self._corr_matrix_df(omic1, omic2, "pearson", device)
    self._matrix_fig(m, f"{_omic(omic1)}_pearson", top_rows=30,
                     cmap="coolwarm", center_zero=True)
    return self

  def plot_spearman_matrix(self, omic1="transcriptomic", omic2="proteomic",
                           device="cuda") -> "_OMICvisualizer":
    m = self._corr_matrix_df(omic1, omic2, "spearman", device)
    self._matrix_fig(m, f"{_omic(omic1)}_spearman", top_rows=30,
                     cmap="coolwarm", center_zero=True)
    return self

  def _matrix_fig(self, df, name: str, top_rows: int = 30,
                  cmap: str = "viridis", center_zero: bool = False):
    """``df`` is (values, row names, column names); the ``top_rows`` rows
    of the largest |value| are kept, as ``np.argsort`` orders them."""
    values, index, columns = df
    if values.shape[0] > top_rows:  # keep most informative rows
      order = np.argsort(-np.abs(values).max(1))[:top_rows]
      values, index = values[order], [index[i] for i in order]
    data = dict(values=values, index=list(index), columns=list(columns),
                cmap=cmap, center_zero=center_zero)
    self._draw(name, data, _render_matrix)

  def plot_correlation_scatter(self,
                               omic1="transcriptomic",
                               omic2="proteomic",
                               n_pairs: int = 9,
                               device="cuda") -> "_OMICvisualizer":
    """Scatter of the top marker gene↔protein pairs (the most correlated
    pairs when no marker pair is present)."""
    dev = _dev(device)
    omic1, omic2 = _omic(omic1), _omic(omic2)
    pairs = self.get_marker_pairs(omic1, omic2)
    vi1, vi2 = self.get_var_indices(omic1), self.get_var_indices(omic2)
    if not pairs:
      corr = self.get_correlation(omic1, omic2, device=device)[:n_pairs]
      names1, names2 = self.get_var_names(omic1), self.get_var_names(omic2)
      pairs = [(str(names1[i]), str(names2[j])) for i, j, _, _ in corr]
    pairs = pairs[:n_pairs]
    x1 = torch.log1p(self._tensor(omic1, dev)[:, torch.as_tensor(
        [vi1[a] for a, _ in pairs], device=dev, dtype=torch.long)])
    x2 = torch.log1p(self._tensor(omic2, dev)[:, torch.as_tensor(
        [vi2[b] for _, b in pairs], device=dev, dtype=torch.long)])
    data = dict(pairs=[(str(a), str(b)) for a, b in pairs], x1=_host(x1),
                x2=_host(x2))
    return self._draw(f"{omic1}_{omic2}_corr_scatter", data,
                      _render_correlation_scatter)

  def plot_divergence(self,
                      X="transcriptomic",
                      omic="proteomic",
                      algo: str = "tsne",
                      device="cuda") -> "_OMICvisualizer":
    """Embedding colored by each protein level."""
    dev = _dev(device)
    omic_x, omic_c = _omic(X), _omic(omic)
    emb = self.dimension_reduce(omic_x, n_components=2, algo=algo,
                                device=device)
    n = min(9, self.get_dim(omic_c))
    y = torch.log1p(self._tensor(omic_c, dev)[:, :n])
    names = self.get_var_names(omic_c)
    data = dict(emb=np.asarray(emb), y=_host(y),
                names=[str(names[k]) for k in range(n)])
    return self._draw(f"{omic_x}_{omic_c}_divergence", data,
                      _render_divergence)

  def plot_histogram(self, omic=None, bins: int = 80,
                     device="cuda") -> "_OMICvisualizer":
    """Library sizes and the log1p counts (a uniform sample of 200,000
    entries drawn by ``default_rng(0)`` when there are more)."""
    dev = _dev(device)
    omic = self.current_omic if omic is None else _omic(omic)
    x = self._tensor(omic, dev)
    flat = x.reshape(-1)
    if flat.numel() > 200000:
      rng = np.random.default_rng(0)
      flat = flat[torch.as_tensor(rng.choice(flat.numel(), 200000,
                                             replace=False), device=dev)]
    data = dict(lib=_host(x.sum(1)), counts=_host(torch.log1p(flat)),
                bins=bins)
    return self._draw(f"{omic}_histogram", data, _render_histogram)

  def plot_percentile_histogram(self, omic=None, n_hist: int = 8,
                                bins: int = 60,
                                device="cuda") -> "_OMICvisualizer":
    """Histogram of vars grouped by expression percentile."""
    from ..analysis.stats import column_sum
    dev = _dev(device)
    omic = self.current_omic if omic is None else _omic(omic)
    x = self._tensor(omic, dev)
    totals = _host(column_sum(x))
    qs = np.percentile(totals, np.linspace(0, 100, n_hist + 1))
    panels = []
    for i in range(n_hist):
      m = np.where((totals >= qs[i]) & (totals <= qs[i + 1]))[0]
      vals = torch.log1p(x[:, torch.as_tensor(m, device=dev)]).reshape(-1)
      panels.append(_host(vals[:100000]))
    data = dict(panels=panels, n_hist=n_hist, bins=bins)
    return self._draw(f"{omic}_percentile_histogram", data,
                      _render_percentile_histogram)

  def plot_series(self, omic=None, var_names: Optional[Sequence[str]] = None,
                  device="cuda") -> "_OMICvisualizer":
    """Sorted expression series of selected vars."""
    dev = _dev(device)
    omic = self.current_omic if omic is None else _omic(omic)
    if var_names is None:
      var_names = list(self.top_vars(omic, 5, device=device))
    vi = self.get_var_indices(omic)
    x = self._tensor(omic, dev)[:, torch.as_tensor(
        [vi[str(v)] for v in var_names], device=dev, dtype=torch.long)]
    series = torch.sort(torch.log1p(x), dim=0).values
    data = dict(series=_host(series).T, names=[str(v) for v in var_names])
    return self._draw(f"{omic}_series", data, _render_series)


# --------------------------------------------------------------- data helpers
def _table_arrays(table):
  """The analyzer's ``{'index': names, column: values, …}`` table as
  (values, row names, column names)."""
  cols = [k for k in table if k != "index"]
  values = np.stack([np.asarray(table[k], np.float64) for k in cols], 1)
  return values, [str(v) for v in table["index"]], cols


def _cdist(cent: torch.Tensor, metric: str) -> np.ndarray:
  """Pairwise distances of the centroids in float64: Euclidean in torch,
  any other scipy metric by scipy on the host."""
  c = cent.to(torch.float64)
  if metric == "euclidean":
    return _host(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1).sqrt())
  from scipy.spatial.distance import cdist
  c = _host(c)
  return cdist(c, c, metric=metric)


# ------------------------------------------------------------- render steps
def _render_violins(group, var, value, categories, n_vars, swap_axes, desc):
  sns = _seaborn()
  import pandas as pd
  plt = _pyplot()
  melt = pd.DataFrame({
      "group": pd.Categorical(group, categories=categories),
      "var": var, "value": value})
  xvar, hue = ("group", "var") if swap_axes else ("var", "group")
  fig, ax = plt.subplots(figsize=(max(8, n_vars), 5))
  sns.violinplot(data=melt, x=xvar, y="value", hue=hue, ax=ax,
                 cut=0, linewidth=0.4, density_norm="width")
  ax.legend(fontsize=6)
  ax.tick_params(axis="x", rotation=45)
  ax.set_title(desc, fontsize=9)
  return fig


def _render_dotplot(mean, frac, var_list, uniq, link, bounds, cmap,
                    standard_scale, desc):
  from scipy.cluster import hierarchy
  plt = _pyplot()
  nv, ng = len(var_list), len(uniq)
  fig = plt.figure(figsize=(max(6, nv * 0.6) + (1.2 if link is not None
                                                else 0), max(4, ng * 0.4)))
  if link is not None:
    gs = fig.add_gridspec(1, 2, width_ratios=[5, 1], wspace=0.05)
    ax = fig.add_subplot(gs[0])
    ax_d = fig.add_subplot(gs[1], sharey=None)
    with plt.rc_context({"lines.linewidth": 0.8}):
      hierarchy.dendrogram(link, ax=ax_d, orientation="right",
                           no_labels=True, link_color_func=lambda _: "k")
    ax_d.axis("off")
  else:
    ax = fig.add_subplot(111)
  gi, vj = np.meshgrid(np.arange(ng), np.arange(nv), indexing="ij")
  sc = ax.scatter(vj.ravel(), gi.ravel(), s=20 + 180 * frac.ravel(),
                  c=mean.ravel(), cmap=cmap)
  if bounds is not None:  # rank-genes panel: separate per-group blocks
    for b in bounds[1:-1]:
      ax.axvline(b - 0.5, color="0.7", lw=0.8)
  ax.set_xticks(range(nv))
  ax.set_xticklabels([str(v) for v in var_list], rotation=45, fontsize=7,
                     ha="right")
  ax.set_yticks(range(ng))
  ax.set_yticklabels([str(u) for u in uniq], fontsize=7)
  fig.colorbar(sc, ax=ax, label="mean expression"
               + (" (scaled)" if standard_scale else ""))
  ax.set_title(desc, fontsize=9)
  return fig


def _render_heatmap(x, sizes, var_list, uniq, link, bounds, swap_axes, cmap,
                    desc):
  from scipy.cluster import hierarchy
  plt = _pyplot()
  row_bounds = np.cumsum(sizes)
  centers = row_bounds - np.asarray(sizes) / 2.0
  nv = len(var_list)
  fig = plt.figure(figsize=((10, 7) if swap_axes else
                            (max(8, nv * 0.3), 7)))
  if link is not None:
    if swap_axes:
      gs = fig.add_gridspec(2, 1, height_ratios=[1, 5], hspace=0.05)
      ax_d = fig.add_subplot(gs[0])
      ax = fig.add_subplot(gs[1])
      orientation = "top"
    else:
      gs = fig.add_gridspec(1, 2, width_ratios=[5, 1], wspace=0.05)
      ax = fig.add_subplot(gs[0])
      ax_d = fig.add_subplot(gs[1])
      orientation = "right"
    with plt.rc_context({"lines.linewidth": 0.8}):
      hierarchy.dendrogram(link, ax=ax_d, orientation=orientation,
                           no_labels=True, link_color_func=lambda _: "k")
    if not swap_axes:
      # scipy puts leaves[0] at the bottom for orientation='right', imshow
      # draws row 0 at the top: inverted, the tree follows the blocks
      ax_d.invert_yaxis()
    ax_d.axis("off")
  else:
    ax = fig.add_subplot(111)
  im = ax.imshow(x.T if swap_axes else x, aspect="auto", cmap=cmap,
                 interpolation="nearest")
  var_axis, group_axis = ("y", "x") if swap_axes else ("x", "y")
  # variable labels only below 50 names
  var_ticks = (range(nv), [str(v) for v in var_list]) if nv < 50 \
      else ([], [])
  getattr(ax, f"set_{var_axis}ticks")(var_ticks[0])
  getattr(ax, f"set_{var_axis}ticklabels")(
      var_ticks[1], fontsize=6,
      **({"rotation": 90} if var_axis == "x" else {}))
  # group blocks: labels at block centers, separators at boundaries
  getattr(ax, f"set_{group_axis}ticks")(centers)
  getattr(ax, f"set_{group_axis}ticklabels")(
      [str(u) for u in uniq], fontsize=7,
      **({"rotation": 45} if group_axis == "x" else {}))
  sep = ax.axvline if swap_axes else ax.axhline
  for b in row_bounds[:-1]:
    sep(b - 0.5, color="w", lw=1.0)
  if bounds is not None:  # rank-vars panel: per-group var-block separators
    vsep = ax.axhline if swap_axes else ax.axvline
    for b in bounds[1:-1]:
      vsep(b - 0.5, color="w", lw=0.8)
  fig.colorbar(im, ax=ax)
  ax.set_title(desc, fontsize=9)
  return fig


def _render_dendrogram_heatmap(cent, uniq, link, order, var_names):
  from scipy.cluster import hierarchy
  plt = _pyplot()
  fig, (ax_d, ax_h) = plt.subplots(
      2, 1, figsize=(max(6, len(var_names) * 0.35), 7),
      gridspec_kw={"height_ratios": [1, 3]}, sharex=False)
  if link is not None:
    hierarchy.dendrogram(link, ax=ax_d, labels=list(uniq), leaf_font_size=7)
  else:
    ax_d.axis("off")
  ax_d.set_yticks([])
  im = ax_h.imshow(cent[order], aspect="auto", cmap="viridis",
                   interpolation="nearest")
  ax_h.set_xticks(range(len(var_names)))
  ax_h.set_xticklabels([str(v) for v in var_names], rotation=90,
                       fontsize=6)
  ax_h.set_yticks(range(len(uniq)))
  ax_h.set_yticklabels([str(uniq[i]) for i in order], fontsize=7)
  fig.colorbar(im, ax=ax_h)
  fig.tight_layout()
  return fig


def _render_distance_heatmap(dm, uniq, title=None):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(6, 5))
  im = ax.imshow(dm, cmap="magma")
  ax.set_xticks(range(len(uniq)))
  ax.set_xticklabels(uniq, rotation=45, fontsize=7, ha="right")
  ax.set_yticks(range(len(uniq)))
  ax.set_yticklabels(uniq, fontsize=7)
  if title is not None:
    ax.set_title(title)
  fig.colorbar(im, ax=ax)
  return fig


def _render_matrix(values, index, columns, cmap, center_zero):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(max(6, values.shape[1] * 0.4),
                                  max(4, values.shape[0] * 0.25)))
  vmax = np.abs(values).max() or 1.0
  kw = dict(vmin=-vmax, vmax=vmax) if center_zero else {}
  im = ax.imshow(values, aspect="auto", cmap=cmap, **kw)
  ax.set_xticks(range(values.shape[1]))
  ax.set_xticklabels(columns, rotation=90, fontsize=6)
  ax.set_yticks(range(values.shape[0]))
  ax.set_yticklabels(index, fontsize=6)
  fig.colorbar(im, ax=ax)
  fig.tight_layout()
  return fig


def _render_correlation_scatter(pairs, x1, x2):
  plt = _pyplot()
  ncol = 3
  nrow = int(np.ceil(len(pairs) / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 3 * nrow),
                           squeeze=False)
  for k, (a, b) in enumerate(pairs):
    ax = axes[k // ncol][k % ncol]
    ax.scatter(x1[:, k], x2[:, k], s=4, alpha=0.3, linewidths=0)
    ax.set_title(f"{a} vs {b}", fontsize=8)
  fig.tight_layout()
  return fig


def _render_divergence(emb, y, names):
  plt = _pyplot()
  n = len(names)
  ncol = 3
  nrow = int(np.ceil(n / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 3 * nrow),
                           squeeze=False)
  for k in range(n):
    ax = axes[k // ncol][k % ncol]
    sc = ax.scatter(emb[:, 0], emb[:, 1], s=4, c=y[:, k], cmap="inferno",
                    linewidths=0)
    ax.set_title(str(names[k]), fontsize=8)
    ax.set_xticks([]); ax.set_yticks([])
    fig.colorbar(sc, ax=ax)
  fig.tight_layout()
  return fig


def _render_histogram(lib, counts, bins):
  plt = _pyplot()
  fig, axes = plt.subplots(1, 2, figsize=(10, 4))
  axes[0].hist(lib, bins=bins)
  axes[0].set_title("library size / cell")
  axes[1].hist(counts, bins=bins)
  axes[1].set_title("log1p counts")
  fig.tight_layout()
  return fig


def _render_percentile_histogram(panels, n_hist, bins):
  plt = _pyplot()
  fig, axes = plt.subplots(1, n_hist, figsize=(2.2 * n_hist, 2.4),
                           squeeze=False)
  for i in range(n_hist):
    axes[0][i].hist(panels[i], bins=bins)
    axes[0][i].set_title(f"p{int(100*i/n_hist)}-{int(100*(i+1)/n_hist)}",
                         fontsize=7)
    axes[0][i].set_yticks([])
  fig.tight_layout()
  return fig


def _render_series(series, names):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(8, 4))
  for s, v in zip(series, names):
    ax.plot(s, lw=1, label=str(v))
  ax.legend(fontsize=7)
  ax.set_xlabel("cell rank")
  ax.set_ylabel("log1p count")
  fig.tight_layout()
  return fig

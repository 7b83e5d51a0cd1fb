"""ResultsSheet: the score table over many posteriors (port of the table
part of ``sisua_tpu/analysis/results_sheet.py``, without pandas).

``get_scores()`` gives ``{posterior name: {metric: value}}``, each
posterior's ``save_scores()``; ``save_scores(path)`` writes it as
``<base>.csv`` (parsing to the JAX sheet's table: a row per posterior, the
union of the metrics as columns, an empty field where a posterior lacks
one) and ``<base>.html``; ``summary()`` (also ``str``) lists the
posteriors and their omics, and the sheet indexes as the JAX one does.
Two posteriors of one name are renamed
``name_1``, ``name_2``, … as the JAX sheet does.

The sheet is a ``Visualizer`` with the JAX sheet's comparison figures
(score bars, the rank heatmap, the pooled seaborn bar and box plots, the
per-protein F1 series, the marker-pair scatters, the posteriors' own
scatters and the learning curves), under the JAX names. Their data
steps read the score table and the posteriors' arrays (correlations on
the first posterior's model device); ``figure_data()`` runs them alone.
"""

from __future__ import annotations

import csv
import html
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.visualization import Visualizer, _pyplot, _seaborn
from .posterior import Posterior

__all__ = ["ResultsSheet"]


class ResultsSheet(Visualizer):
  """The score table of several fitted models' posteriors."""

  def __init__(self, *posteriors: Posterior, verbose: bool = False):
    flat: List[Posterior] = []
    for p in posteriors:
      flat.extend(p if isinstance(p, (list, tuple)) else [p])
    if not flat or not all(isinstance(p, Posterior) for p in flat):
      raise ValueError("ResultsSheet needs one or more Posterior objects")
    seen: Dict[str, int] = {}
    for p in flat:
      n = p.name
      if n in seen:
        seen[n] += 1
        p.name = f"{n}_{seen[n]}"
      else:
        seen[n] = 0
    self.posteriors = flat
    self.verbose = bool(verbose)
    self._scores: Optional[Dict[str, Dict[str, float]]] = None

  @property
  def names(self) -> List[str]:
    return [p.name for p in self.posteriors]

  def get_scores(self, recompute: bool = False) -> Dict[str, Dict[str, float]]:
    """``{posterior name: {metric: value}}``."""
    if self._scores is None or recompute:
      scores = {}
      for p in self.posteriors:
        if self.verbose:
          print(f"[results] scoring {p.name}")
        scores[p.name] = p.save_scores()
      self._scores = scores
    return self._scores

  def save_scores(self, path: str) -> str:
    """Write the table as ``<base>.csv`` and ``<base>.html``; returns the
    CSV's path."""
    scores = self.get_scores()
    metrics = list({m: None for row in scores.values() for m in row})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base, _ = os.path.splitext(path)

    def cell(row, m, fmt):
      v = row.get(m)
      return "" if v is None or math.isnan(float(v)) else fmt(float(v))

    with open(base + ".csv", "w", newline="") as f:
      w = csv.writer(f)
      w.writerow([""] + metrics)
      for name, row in scores.items():
        w.writerow([name] + [cell(row, m, repr) for m in metrics])
    head = "".join(f"<th>{html.escape(m)}</th>" for m in metrics)
    body = "".join(
        f"<tr><th>{html.escape(name)}</th>"
        + "".join(f"<td>{cell(row, m, lambda v: f'{v:.4f}') or 'NaN'}</td>"
                  for m in metrics) + "</tr>\n"
        for name, row in scores.items())
    with open(base + ".html", "w") as f:
      f.write(f'<table border="1" class="dataframe">\n<thead><tr><th></th>'
              f"{head}</tr></thead>\n<tbody>\n{body}</tbody>\n</table>\n")
    return base + ".csv"

  # ----------------------------------------------------------------- plots
  def _columns(self) -> List[str]:
    """The table's metric columns: their union, in first-seen order."""
    return list({m: None for row in self.get_scores().values()
                 for m in row})

  def _bar_compare(self, columns: Sequence[str], title: str):
    """The bars' data: each posterior's values of the present columns
    (NaN where it lacks one); None when no column is present."""
    have = set(self._columns())
    cols = [c for c in columns if c in have]
    if not cols:
      return None
    rows = [(name, [float(row.get(c, np.nan)) for c in cols])
            for name, row in self.get_scores().items()]
    return dict(cols=cols, rows=rows, title=title)

  def _bar_figure(self, name: str, columns: Sequence[str], title: str):
    data = self._bar_compare(columns, title)
    if data is not None:
      self._draw(name, data, _render_bar_compare)
    return self

  def plot_imputation_scores(self) -> "ResultsSheet":
    return self._bar_figure(
        "imputation_scores",
        ["imputation_med", "imputation_mean", "imputation_std"],
        "imputation error (lower is better)")

  def plot_correlation_scores(self) -> "ResultsSheet":
    return self._bar_figure("correlation_scores",
                            ["spearman_mean", "pearson_mean"],
                            "marker gene↔protein correlation")

  def plot_classifier_F1(self) -> "ResultsSheet":
    cols = [c for c in self._columns() if c.startswith("f1_")]
    return self._bar_figure("classifier_f1", cols[:12], "latent→protein F1")

  def plot_disentanglement_scores(self) -> "ResultsSheet":
    cols = [c for c in self._columns()
            if c.split("_")[0] in ("mig", "dci", "disentanglement",
                                   "completeness", "informativeness")]
    return self._bar_figure("disentanglement_scores", cols[:10],
                            "disentanglement")

  def plot_protein_prediction_scores(self) -> "ResultsSheet":
    return self._bar_figure("protein_prediction_scores",
                            ["protein_pearson_mean",
                             "protein_spearman_mean"],
                            "direct protein prediction (semi-supervised)")

  def plot_clustering_scores(self) -> "ResultsSheet":
    cols = [c for c in self._columns()
            if c.split("_")[0] in ("ARI", "NMI", "ASW", "UCA")]
    return self._bar_figure("clustering_scores", cols[:8],
                            "latent clustering vs labels")

  def plot_llk_scores(self) -> "ResultsSheet":
    cols = [c for c in self._columns()
            if c.startswith(("llk_", "marginal_llk"))]
    return self._bar_figure("llk_scores", cols[:8],
                            "log-likelihood (higher is better)")

  def plot_ranking_heatmap(self) -> "ResultsSheet":
    """Models × metrics heatmap of per-metric ranks (1 = best, ties
    averaged), error-like metrics (imputation_*) ranked ascending; the
    metrics some model lacks, constant ones and 'beta*' are left out."""
    from scipy.stats import rankdata
    scores = self.get_scores()
    names = list(scores)
    cols = self._columns()
    m = np.array([[float(scores[n].get(c, np.nan)) for c in cols]
                  for n in names], np.float64).reshape(len(names), len(cols))
    full = ~np.isnan(m).any(0)
    keep = [j for j, c in enumerate(cols)
            if full[j] and len(names) > 1 and np.std(m[:, j], ddof=1) > 0
            and not c.startswith(("beta",))]
    if not keep or len(names) < 2:
      return self
    m = m[:, keep]
    cols = [cols[j] for j in keep]
    ranks = np.stack([rankdata(m[:, j] if c.startswith("imputation")
                               else -m[:, j])
                      for j, c in enumerate(cols)], 1)
    return self._draw("ranking_heatmap",
                      dict(ranks=ranks, cols=cols, names=names),
                      _render_ranking)

  # -------------------------------------------------- pooled bar/box plots
  def _bar_box_line(self, title: str, ylabel: str, get_scores,
                    using_bar: bool = True, ignore: Sequence[str] = (),
                    ax=None) -> "ResultsSheet":
    """Pooled per-item scores (per-protein F1, per-pair correlations, …)
    per model as a seaborn bar or box plot, figure named ``title``."""
    models, values = [], []
    for p in self.posteriors:
      scores = dict(get_scores(p))
      for k in ignore:
        scores.pop(k, None)
      for v in scores.values():
        models.append(p.name)
        values.append(float(v))
    if not models:
      return self
    data = dict(models=models, values=np.asarray(values), ylabel=ylabel,
                using_bar=using_bar, n_models=len(self.posteriors),
                title=title)
    return self._draw(title, data,
                      lambda **d: _render_bar_box(ax=ax, **d))

  @staticmethod
  def _per_item(d: Dict[str, float], prefix: str,
                drop_means: bool = True) -> Dict[str, float]:
    out = {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}
    if drop_means:
      out = {k: v for k, v in out.items()
             if not k.endswith(("mean", "micro", "macro", "weight"))}
    return out

  def boxplot_cluster(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line("boxplot_cluster", "Pooled Cluster Metrics",
                              lambda p: p.cal_clustering_scores(),
                              using_bar=False, ax=ax)

  def boxplot_f1(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "boxplot_classifier", "F1 score",
        lambda p: self._per_item(p.cal_protein_classification(), "f1_"),
        using_bar=False, ax=ax)

  def boxplot_pearson(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "boxplot_pearson", "Pearson correlation",
        lambda p: self._per_item(p.cal_pearson(), "pearson_"),
        using_bar=False, ax=ax)

  def boxplot_spearman(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "boxplot_spearman", "Spearman correlation",
        lambda p: self._per_item(p.cal_spearman(), "spearman_"),
        using_bar=False, ax=ax)

  def barplot_cluster(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line("barplot_cluster", "Pooled Cluster Metrics",
                              lambda p: p.cal_clustering_scores(), ax=ax)

  def barplot_f1(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "barplot_classifier", "F1 score",
        lambda p: self._per_item(p.cal_protein_classification(), "f1_"),
        ax=ax)

  def barplot_pearson(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "barplot_pearson", "Pearson correlation",
        lambda p: self._per_item(p.cal_pearson(), "pearson_"), ax=ax)

  def barplot_spearman(self, ax=None) -> "ResultsSheet":
    return self._bar_box_line(
        "barplot_spearman", "Spearman correlation",
        lambda p: self._per_item(p.cal_spearman(), "spearman_"), ax=ax)

  def plot_comparison_f1(self, fig_width: int = 12) -> "ResultsSheet":
    """Per-protein F1 series, one panel per model with the mean line."""
    series = []
    for p in self.posteriors:
      f1 = self._per_item(p.cal_protein_classification(), "f1_")
      if f1:
        series.append((p.name, dict(sorted(f1.items()))))
    if not series:
      return self
    labels = list(series[0][1].keys())
    vals = [[100.0 * f1.get(l, np.nan) for l in labels] for _, f1 in series]
    data = dict(names=[n for n, _ in series], labels=labels,
                values=np.asarray(vals, np.float64), fig_width=fig_width)
    return self._draw("compare_classifier_f1", data, _render_comparison_f1)

  def plot_correlation_marker_pairs(self, imputed: bool = True,
                                    fontsize: int = 8,
                                    max_pairs: int = 6) -> "ResultsSheet":
    """Marker gene↔protein scatter per pair × (Original + each model's
    imputed series), titled with their Pearson and Spearman (computed on
    the first posterior's model device)."""
    from .imputation import correlation_scores
    from .stats import correlations
    p0 = self.posteriors[0]
    if "proteomic" not in p0.data:
      return self
    y = p0.original("proteomic")
    original = correlation_scores(p0.original(p0.main_omic), y,
                                  p0.var_names[p0.main_omic],
                                  p0.var_names["proteomic"],
                                  return_series=True)
    if not original:
      return self
    imputed_series = [correlation_scores(
        p.analysis[f"i{p.main_omic}"], p.original("proteomic"),
        p.var_names[p.main_omic], p.var_names["proteomic"],
        return_series=True) for p in self.posteriors]
    pairs = list(original.keys())[:max_pairs]
    panels = []
    for pair in pairs:
      cols = [("Original", *original[pair])]
      cols += [(p.name, *s[pair]) for p, s in zip(self.posteriors,
                                                  imputed_series)
               if pair in s]
      row = []
      for name, g, prot in cols:
        if np.std(g) > 0:
          pe, sp = correlations(g[:, None], prot[:, None],
                                device=p0.scm.device)
          pe, sp = float(pe[0, 0]), float(sp[0, 0])
        else:
          pe = sp = 0.0
        row.append((name, g, prot, pe, sp))
      panels.append((pair, row))
    data = dict(panels=panels, n_cols=1 + len(self.posteriors),
                fontsize=fontsize)
    return self._draw("correlation_marker_pairs", data,
                      _render_marker_pairs)

  def plot_latents_binary_scatter(self) -> "ResultsSheet":
    """Each posterior's binary-protein latent scatter."""
    for p in self.posteriors:
      self._take(p, p.plot_latents_binary)
    return self

  def plot_scores(self, score_type: str = "imputation",
                  width: float = 0.2) -> "ResultsSheet":
    """Grouped bars over the columns of a score-family prefix."""
    cols = [c for c in self._columns() if c.startswith(score_type)]
    return self._bar_figure(f"scores_{score_type}", cols[:12],
                            f"{score_type} scores")

  def plot_imputation_scatter(self) -> "ResultsSheet":
    for p in self.posteriors:
      self._take(p, p.plot_imputation_scatter)
    return self

  def plot_latents_scatter(self, algo: str = "pca") -> "ResultsSheet":
    for p in self.posteriors:
      self._take(p, lambda p=p: p.plot_scatter(algo=algo))
    return self

  def plot_learning_curves(self) -> "ResultsSheet":
    curves = []
    for p in self.posteriors:
      hist = p.scm.history
      if "loss" in hist:
        curves.append((np.asarray(hist["loss"], np.float64), "-",
                       f"{p.name}"))
      if "val_loss" in hist:
        curves.append((np.asarray(hist["val_loss"], np.float64), "--",
                       f"{p.name} (val)"))
    return self._draw("learning_curves", dict(curves=curves),
                      _render_sheet_curves)

  def plot_all(self) -> "ResultsSheet":
    """The comparison battery. Outside ``figure_data()`` it needs
    matplotlib and seaborn and raises at once without them."""
    if not self._data_only:
      _seaborn()
    return (self.plot_imputation_scores().plot_correlation_scores()
            .plot_protein_prediction_scores().plot_clustering_scores()
            .plot_llk_scores().plot_classifier_F1()
            .plot_disentanglement_scores().plot_ranking_heatmap()
            .plot_comparison_f1().plot_correlation_marker_pairs()
            .boxplot_f1().boxplot_spearman().barplot_cluster()
            .plot_learning_curves())

  def save_plots(self, path: str, dpi: int = 120,
                 separate_files: bool = True) -> "ResultsSheet":
    """``save_figures`` under the JAX sheet's name."""
    return self.save_figures(path, dpi=dpi, separate_files=separate_files)

  def summary(self) -> str:
    lines = [f"ResultsSheet: {len(self)} posteriors"]
    for p in self.posteriors:
      lines.append(f"  {p.name}: omics={list(p.data)}")
    return "\n".join(lines)

  def __str__(self):
    return self.summary()

  def __len__(self):
    return len(self.posteriors)

  def __getitem__(self, key):
    """A string matches the full posterior name first, then any
    '_'-token of a name, case-insensitively; a callable filters; an int
    or a slice indexes."""
    if isinstance(key, str):
      for p in self.posteriors:
        if p.name == key:
          return p
      for p in self.posteriors:
        if key.lower() in p.name.lower().split("_"):
          return p
      raise KeyError(key)
    if callable(key):
      for p in self.posteriors:
        if key(p):
          return p
      raise KeyError(key)
    return self.posteriors[key]

  def __iter__(self):
    return iter(self.posteriors)

  def __repr__(self):
    return f"ResultsSheet({', '.join(self.names)})"


# ------------------------------------------------------------- render steps
def _render_bar_compare(cols, rows, title):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(cols)), 4))
  x = np.arange(len(cols))
  w = 0.8 / len(rows)
  for i, (name, values) in enumerate(rows):
    ax.bar(x + i * w, values, w, label=name)
  ax.set_xticks(x + 0.4)
  ax.set_xticklabels(cols, rotation=30, fontsize=7, ha="right")
  ax.legend(fontsize=7)
  ax.set_title(title)
  fig.tight_layout()
  return fig


def _render_ranking(ranks, cols, names):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(max(6, 0.45 * ranks.shape[1]),
                                  max(3, 0.45 * ranks.shape[0])))
  im = ax.imshow(ranks, aspect="auto", cmap="RdYlGn_r")
  ax.set_xticks(range(ranks.shape[1]))
  ax.set_xticklabels(cols, rotation=90, fontsize=6)
  ax.set_yticks(range(ranks.shape[0]))
  ax.set_yticklabels(names, fontsize=7)
  for i in range(ranks.shape[0]):
    for j in range(ranks.shape[1]):
      ax.text(j, i, f"{int(ranks[i, j])}", ha="center", va="center",
              fontsize=6)
  ax.set_title("per-metric model rank (1 = best)")
  fig.colorbar(im, ax=ax)
  fig.tight_layout()
  return fig


def _render_bar_box(models, values, ylabel, using_bar, n_models, title,
                    ax=None):
  sns = _seaborn()
  import pandas as pd
  plt = _pyplot()
  df = pd.DataFrame({"Model": models, ylabel: values})
  if ax is None:
    _, ax = plt.subplots(figsize=(max(6, 1.2 * n_models), 4))
  if using_bar:
    sns.barplot(x="Model", y=ylabel, data=df, ax=ax)
  else:
    sns.boxplot(x="Model", y=ylabel, data=df, ax=ax)
  ax.grid(axis="y", linewidth=1.2, alpha=0.5)
  ax.set_axisbelow(True)
  ax.set_title(title, fontsize=9)
  return ax.get_figure()


def _render_comparison_f1(names, labels, values, fig_width):
  plt = _pyplot()
  fig, axes = plt.subplots(1, len(names), sharey=True, squeeze=False,
                           figsize=(fig_width, 2.5))
  colors = plt.cm.tab10(np.linspace(0, 1, max(len(labels), 2)))
  for idx, name in enumerate(names):
    ax = axes[0][idx]
    vals = list(values[idx])
    ax.grid(True, axis="both", linewidth=0.5, alpha=0.6)
    for i, (v, c) in enumerate(zip(vals, colors)):
      ax.scatter(i, v, color=c, s=22, alpha=0.8)
    ax.plot(np.arange(len(labels)), vals, lw=1.0, ls="--")
    mean = float(np.nanmean(vals))
    ax.axhline(mean, lw=1.2, ls=":", color="black")
    ax.text(0, mean + 3, r"$\overline{F1}$:%.1f" % mean, fontsize=8)
    ax.set_xticks(np.arange(len(labels)))
    ax.set_xticklabels(labels if idx == 0 else [""] * len(labels),
                       rotation=90, fontsize=6)
    ax.set_xlabel(name, fontsize=10)
    ax.set_ylim(-8, 130)
    ax.set_yticks(np.linspace(0, 100, 5))
  fig.tight_layout(w_pad=0)
  return fig


def _render_marker_pairs(panels, n_cols, fontsize):
  plt = _pyplot()
  fig, axes = plt.subplots(len(panels), n_cols, squeeze=False,
                           figsize=(4 * n_cols, 3.2 * len(panels)))
  for r, (pair, row) in enumerate(panels):
    for c, (name, g, prot, pe, sp) in enumerate(row):
      ax = axes[r][c]
      ax.scatter(prot, g, s=18, alpha=0.6, linewidths=0)
      ax.set_title(f"{pair} - {name}\nPearson:{pe:.2f} "
                   f"Spearman:{sp:.2f}", fontsize=fontsize)
      if c == 0:
        prot_nm, gene_nm = pair.split("/")
        ax.set_xlabel(f"[Protein] {prot_nm}", fontsize=fontsize)
        ax.set_ylabel(f"[Gene] {gene_nm}", fontsize=fontsize)
  fig.tight_layout()
  return fig


def _render_sheet_curves(curves):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(7, 4))
  for values, style, label in curves:
    if style == "-":
      ax.plot(values, label=label)
    else:
      ax.plot(values, style, label=label)
  ax.legend(fontsize=7)
  ax.set_xlabel("epoch")
  ax.set_ylabel("loss")
  return fig

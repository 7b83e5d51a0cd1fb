"""Imputation scores (port of ``sisua_tpu/analysis/imputation.py``).

  * ``imputation_score``: median of |original − imputed| over all entries;
  * ``imputation_mean_score`` / ``imputation_std_score``: mean / std over
    the corrupted cells of each cell's median |original − imputed|;
  * ``correlation_scores``: Spearman and Pearson between each marker gene
    of the imputed matrix and its protein;
  * ``get_imputed_indices``: the cells whose row sums changed.

Each takes numpy arrays or tensors. With a tensor among the arguments the
score is computed where that tensor lies (the others are moved there),
and a median is ``np.median``'s: for an even count, the mean of the two
middle values (``torch.median`` returns the lower one).
``plot_imputation`` and ``plot_imputation_series`` compute their log1p
series (and the regression line) in torch where the data lies, and draw
with matplotlib (``utils.visualization``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from scipy import stats as sp_stats

from ..data.const import MARKER_ADT_GENE
from ..data.utils import standardize_protein_name

__all__ = ["imputation_score", "imputation_mean_score",
           "imputation_std_score", "correlation_scores",
           "get_imputed_indices", "plot_imputation",
           "plot_imputation_series"]


def _median(t: torch.Tensor, dim=None) -> torch.Tensor:
  """``np.median`` of a tensor (over everything, or along ``dim``): a sort,
  so no size limit (``torch.quantile`` refuses more than 2^24 elements)."""
  if dim is None:
    t, dim = t.reshape(-1), 0
  n = t.shape[dim]
  s = torch.sort(t, dim=dim).values
  hi = s.narrow(dim, n // 2, 1)
  if n % 2:
    return hi.squeeze(dim)
  return ((s.narrow(dim, n // 2 - 1, 1) + hi) / 2).squeeze(dim)


def _tensors(*arrays):
  """All arguments as tensors on the device of the first tensor among
  them, or None when there is none."""
  dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
             None)
  if dev is None:
    return None
  return [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                          else a, device=dev) for a in arrays]


def get_imputed_indices(x_org, x_imp) -> np.ndarray:
  """Indices of the cells whose counts changed under imputation (row sums
  differ)."""
  t = _tensors(x_org, x_imp)
  if t is not None:
    return torch.nonzero(t[0].sum(1) != t[1].sum(1))[:, 0].cpu().numpy()
  return np.nonzero(np.asarray(x_org).sum(axis=1)
                    != np.asarray(x_imp).sum(axis=1))[0]


def imputation_score(original, imputed) -> float:
  """Median absolute deviation over all entries."""
  if tuple(original.shape) != tuple(imputed.shape):
    raise ValueError(f"shapes differ: {tuple(original.shape)} and "
                     f"{tuple(imputed.shape)}")
  t = _tensors(original, imputed)
  if t is not None:
    return float(_median(torch.abs(t[0] - t[1])))
  return float(np.median(np.abs(original - imputed)))


def _per_cell_scores(original, corrupted, imputed):
  """Each corrupted cell's median |original − imputed|; None when no cell
  was corrupted."""
  t = _tensors(original, corrupted, imputed)
  if t is not None:
    o, c, i = t
    mask = (o != c).any(dim=1)
    if not bool(mask.any()):
      return None
    return _median(torch.abs(o[mask] - i[mask]), 1)
  mask = np.asarray(original != corrupted).any(axis=1)
  if not mask.any():
    return None
  return np.median(np.abs(original[mask] - imputed[mask]), axis=1)


def imputation_mean_score(original, corrupted, imputed) -> float:
  """Mean over corrupted cells of per-cell median |orig − imputed|."""
  per_cell = _per_cell_scores(original, corrupted, imputed)
  return 0.0 if per_cell is None else float(per_cell.mean())


def imputation_std_score(original, corrupted, imputed) -> float:
  """Std over corrupted cells of per-cell median |orig − imputed|."""
  per_cell = _per_cell_scores(original, corrupted, imputed)
  if per_cell is None:
    return 0.0
  if isinstance(per_cell, torch.Tensor):
    return float(per_cell.std(correction=0))
  return float(np.std(per_cell))


def _columns(a, idx) -> np.ndarray:
  """Columns ``idx`` of ``a`` as float64 on the host: a tensor fetches only
  those."""
  if isinstance(a, torch.Tensor):
    a = a[:, torch.as_tensor(idx, device=a.device)].cpu().numpy()
    return np.asarray(a, np.float64)
  return np.asarray(np.asarray(a)[:, idx], np.float64)


def _marker_pairs(gene_name: Sequence[str], protein_name: Sequence[str]):
  """(protein, gene, gene column, protein column) of every protein whose
  marker gene is among ``gene_name``, in protein order."""
  gene_idx = {str(g): i for i, g in enumerate(gene_name)}
  prot_names = [standardize_protein_name(str(p)) for p in protein_name]
  return [(prot, MARKER_ADT_GENE[prot], gene_idx[MARKER_ADT_GENE[prot]], j)
          for j, prot in enumerate(prot_names)
          if MARKER_ADT_GENE.get(prot) in gene_idx]


def correlation_scores(X, y,
                       gene_name: Sequence[str],
                       protein_name: Sequence[str],
                       return_series: bool = False
                       ) -> Dict[str, Tuple]:
  """(spearman, pearson) between each marker gene in ``X`` (cells ×
  genes) and its paired protein in ``y`` (cells × proteins), from the
  marker table (``data.const.MARKER_ADT_GENE``).

  Returns {'<protein>/<gene>': (spearman, pearson)}, or with
  ``return_series=True`` {'<protein>/<gene>': (gene_series,
  prot_series)}. A constant series scores 0. Only the paired columns are
  fetched from a tensor."""
  pairs = _marker_pairs(gene_name, protein_name)
  if not pairs:
    return {}
  gx = _columns(X, [p[2] for p in pairs])
  py = _columns(y, [p[3] for p in pairs])
  scores: Dict[str, Tuple] = {}
  for c, (prot, gene, _, _) in enumerate(pairs):
    a, b = gx[:, c], py[:, c]
    if return_series:
      scores[f"{prot}/{gene}"] = (a, b)
      continue
    if a.std() == 0 or b.std() == 0:
      spear = pear = 0.0
    else:
      spear = float(sp_stats.spearmanr(a, b).statistic)
      pear = float(sp_stats.pearsonr(a, b).statistic)
    scores[f"{prot}/{gene}"] = (spear, pear)
  return scores


def _imputation_series_data(original, imputed) -> dict:
  """log1p of both series in float64, and the least-squares line of the
  imputed on the original."""
  x = torch.log1p(_float64(original).reshape(-1))
  y = torch.log1p(_float64(imputed, x.device).reshape(-1))
  if x.numel() > 1:
    xm, ym = x.mean(), y.mean()
    slope = float(((x - xm) * (y - ym)).sum() / ((x - xm) ** 2).sum())
    intercept = float(ym - slope * xm)
  else:
    slope, intercept = 1.0, 0.0
  return dict(x=x.cpu().numpy(), y=y.cpu().numpy(), slope=slope,
              intercept=intercept)


def _float64(a, device=None) -> torch.Tensor:
  t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
  return t.to(device=device if device is not None else t.device,
              dtype=torch.float64)


def plot_imputation_series(original, imputed, title: str = "Imputation"):
  """Pairwise original/imputed series: joint scatter with a regression
  line + identity, and marginal histograms (a 2×2 grid)."""
  from ..utils.visualization import _pyplot
  d = _imputation_series_data(original, imputed)
  x, y, slope, intercept = d["x"], d["y"], d["slope"], d["intercept"]
  plt = _pyplot()
  max_val = float(max(x.max(), y.max())) if x.size else 1.0
  fig, axes = plt.subplots(2, 2, figsize=(8, 8))
  axes[0][0].hist(x, bins=180, color="g", alpha=0.8)
  axes[0][0].set_xlabel("Original Value")
  axes[1][1].hist(y, bins=180, color="g", alpha=0.8)
  axes[1][1].set_xlabel("Imputed Value")
  grid = np.linspace(0, max_val, 50)
  for ax, (a, b) in ((axes[0][1], (x, y)), (axes[1][0], (y, x))):
    ax.scatter(a, b, s=2, alpha=0.6, color="g", linewidths=0)
    if ax is axes[0][1]:
      fit = slope * grid + intercept
    elif abs(slope) > 1e-8:
      fit = (grid - intercept) / slope  # an anti-correlated imputation
      # keeps its negative slope
    else:
      fit = np.full_like(grid, np.nan)  # vertical line: nothing to draw
    ax.plot(grid, fit, color="red", alpha=0.8, lw=1.2)
    ax.plot(grid, grid, linestyle="--", linewidth=1, color="black")
    ax.set_xlim((0, max_val))
    ax.set_ylim((0, max_val))
  axes[0][1].set_xlabel("Original Value")
  axes[0][1].set_ylabel("Imputed Value")
  axes[1][0].set_xlabel("Imputed Value")
  axes[1][0].set_ylabel("Original Value")
  fig.suptitle(title)
  fig.tight_layout()
  return fig


def _imputation_data(original, imputed, device=None) -> dict:
  """log1p of both matrices, flattened (their dtype), a ``default_rng(0)``
  sample of 200,000 entries when there are more."""
  o = original if isinstance(original, torch.Tensor) else torch.as_tensor(
      np.asarray(original))
  o = o.to(device) if device is not None else o
  i = imputed if isinstance(imputed, torch.Tensor) else torch.as_tensor(
      np.asarray(imputed))
  x, y = torch.log1p(o.reshape(-1)), torch.log1p(i.to(o.device).reshape(-1))
  if len(x) > 200000:
    idx = np.random.default_rng(0).choice(len(x), 200000, replace=False)
    idx = torch.as_tensor(idx, device=x.device)
    x, y = x[idx], y[idx]
  return dict(x=x.cpu().numpy(), y=y.cpu().numpy())


def plot_imputation(original, imputed, corrupted=None,
                    title: str = "Imputation"):
  """Density (hexbin) scatter of the original against the imputed
  values, log1p."""
  d = _imputation_data(original, imputed)
  return _render_imputation(title=title, **d)


def _render_imputation(x, y, title):
  from ..utils.visualization import _pyplot
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(6, 6))
  hb = ax.hexbin(x, y, gridsize=60, bins="log", cmap="viridis")
  lim = max(x.max(), y.max())
  ax.plot([0, lim], [0, lim], "r--", lw=1)
  ax.set_xlabel("log1p original")
  ax.set_ylabel("log1p imputed")
  ax.set_title(title)
  fig.colorbar(hb, ax=ax)
  return fig

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
middle values (``torch.median`` returns the lower one). The plots wait for
the port's plotting layer (ROADMAP A12b).
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
           "get_imputed_indices"]


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

"""Host data helpers (port of ``sisua_tpu/data/utils.py``), with no
pandas: ``get_library_size`` for numpy arrays, scipy sparse matrices and
torch tensors; ``apply_artificial_corruption``, the scVI count dropout
behind every imputation score, bitwise the JAX package's for the same
input and seed; ``standardize_protein_name``; ``read_csv_matrix``, the
counts of a CSV as ``pandas.read_csv(path, index_col=0)`` reads them."""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy import sparse

__all__ = ["get_library_size", "int16_exact", "apply_artificial_corruption",
           "read_csv_matrix",
           "standardize_protein_name"]

# rows per float64 row-sum pass over a tensor: at most 2^25 elements, so the
# float64 copy a pass makes stays ≤ 256 MiB whatever the matrix's size
_SUM_ELEMENTS = 1 << 25


def get_library_size(X, return_log_count: bool = False):
  """Per-cell library statistics in log space (scVI convention).

  Returns ``(local_mean, local_var)``, each (n_cells, 1) float32: the
  dataset-level mean and (population) variance of log total counts,
  broadcast per cell; with ``return_log_count``, ``(log_counts,
  local_mean, local_var)``, the per-cell log total counts first. A torch
  tensor stays on its device."""
  if X.ndim != 2:
    raise ValueError("Only support 2-D matrix")
  n = X.shape[0]
  if isinstance(X, torch.Tensor):
    step = max(1, _SUM_ELEMENTS // max(1, X.shape[1]))
    totals = torch.cat([X[i:i + step].sum(dim=1, dtype=torch.float64)
                        for i in range(0, n, step)])
    log_counts = torch.log(totals + 1e-8)
    mean = log_counts.mean().to(torch.float32)
    var = log_counts.var(correction=0).to(torch.float32)
    mean, var = mean.expand(n, 1).clone(), var.expand(n, 1).clone()
    if return_log_count:
      return log_counts[:, None].to(torch.float32), mean, var
    return mean, var
  total_counts = np.asarray(X.sum(axis=1)).ravel()
  if not np.all(total_counts >= 0):
    warnings.warn(f"Some cell in matrix {X.shape} contains negative counts; "
                  "this yields NaN log counts!")
  log_counts = np.log(total_counts + 1e-8)
  local_mean = np.full((n, 1), np.mean(log_counts), dtype=np.float32)
  local_var = np.full((n, 1), np.var(log_counts), dtype=np.float32)
  if return_log_count:
    return log_counts[:, None].astype(np.float32), local_mean, local_var
  return local_mean, local_var


def int16_exact(values) -> bool:
  """True when every value is an integer with |v| < 32767, the condition
  for an exact int16 upload (port of ``sisua_tpu/ops/sparse.py``
  ``int16_exact``): a full scan in chunks, never a sampled prefix. A torch
  tensor is scanned where it lies."""
  if isinstance(values, torch.Tensor):
    flat = values.reshape(-1)
    for lo in range(0, flat.numel(), 1 << 24):
      chunk = flat[lo:lo + (1 << 24)]
      if not chunk.is_floating_point():
        chunk = chunk.to(torch.float64)
      if not bool(((chunk == torch.round(chunk))
                   & (chunk < 32767) & (chunk > -32767)).all()):
        return False
    return True
  flat = np.asarray(values).reshape(-1)
  for lo in range(0, flat.size, 1 << 24):
    chunk = flat[lo:lo + (1 << 24)]
    # two-sided compare: abs() of the most negative integer overflows
    if (chunk.max() >= 32767 or chunk.min() <= -32767
        or np.any(chunk != np.round(chunk))):
      return False
  return True


def apply_artificial_corruption(x,
                                dropout: float = 0.0,
                                distribution: str = "binomial",
                                retain_rate: float = 0.2,
                                copy: bool = False,
                                seed: int = 8):
  """Corrupt ``dropout`` of the nonzero counts of ``x`` (n_cells, n_genes),
  a numpy array or scipy sparse matrix (scVI protocol): each picked count
  n becomes Binomial(n, retain_rate) ('binomial'), or n·Bernoulli(
  retain_rate) ('uniform'). numpy's ``RandomState(seed)`` draws in the JAX
  package's order (``choice`` over the nonzeros, then ``binomial``), so
  the result is bitwise its. A sparse result is CSR without explicit
  zeros."""
  distribution = str(distribution).lower()
  dropout = float(dropout)
  if not 0.0 <= dropout < 1.0:
    raise ValueError(f"dropout must be in [0, 1), given: {dropout}")
  rand = np.random.RandomState(seed=seed)
  if dropout <= 0.0:
    return x.copy() if copy else x
  corrupted_x = x.copy() if copy else x
  is_sparse = sparse.issparse(x)
  if is_sparse:
    xcoo = x.tocoo()
    i, j, vals = xcoo.row, xcoo.col, xcoo.data
  else:
    i, j = np.nonzero(x)
    vals = np.asarray(x[i, j]).ravel()
  n_pick = int(np.floor(dropout * len(i)))
  ix = rand.choice(len(i), size=n_pick, replace=False)
  i, j, vals = i[ix], j[ix], vals[ix]
  if distribution == "uniform":
    corrupted = vals * rand.binomial(n=np.ones(n_pick, np.int32),
                                     p=retain_rate)
  elif distribution == "binomial":
    corrupted = rand.binomial(n=vals.astype(np.int64), p=retain_rate)
  else:
    raise ValueError("Only support 'uniform' and 'binomial' corruption, "
                     f"given: '{distribution}'")
  if is_sparse:
    corrupted_x = corrupted_x.tolil()
    corrupted_x[i, j] = corrupted
    corrupted_x = corrupted_x.tocsr()
    corrupted_x.eliminate_zeros()
  else:
    corrupted_x[i, j] = corrupted
  return corrupted_x


_PROTEIN_ALIASES = {
    "PD-L1;CD274": "CD274", "PECAM;CD31": "CD31", "CD26;Adenosine": "CD26",
    "CD366;tim3": "CD366", "MHCII;HLA-DR": "MHCII",
    "IL7Ralpha;CD127": "CD127", "PD-1": "PD-1", "PD1": "PD1",
    "B220;CD45R": "CD45R", "Ox40;CD134": "CD134", "CD8a": "CD8",
    "CD8A": "CD8", "CD4 T cells": "CD4", "CD8 T cells": "CD8",
}


def standardize_protein_name(name):
  """Strip TotalSeq suffixes and map known aliases; a sequence gives a
  list."""
  if isinstance(name, (tuple, list, np.ndarray)):
    return [standardize_protein_name(i) for i in name]
  if not isinstance(name, str):
    raise TypeError("Protein name must be a string")
  for sep in ("-", "_"):
    for suffix in ("TotalSeqB", "control", "TotalSeqC", "TotalSeqA"):
      name = name.replace(f"{sep}{suffix}", "")
  name = name.strip()
  return _PROTEIN_ALIASES.get(name, name)


def read_csv_matrix(path: str) -> np.ndarray:
  """The (rows, columns) float32 values of a CSV (``.csv`` or
  ``.csv.gz``) with a header row and an index column, as
  ``pandas.read_csv(path, index_col=0).to_numpy(np.float32)`` reads them:
  the header names the columns, every other row is a label then its
  numbers; an empty field is NaN."""
  import csv
  import gzip
  opener = gzip.open if str(path).endswith(".gz") else open
  with opener(path, "rt", newline="") as f:
    rows = [r for r in csv.reader(f) if r]
  if not rows:
    raise ValueError(f"{path} is empty")
  width = len(rows[0])
  values = []
  for lineno, r in enumerate(rows[1:], start=2):
    if len(r) != width:
      raise ValueError(f"{path}:{lineno}: {len(r)} fields, the header has "
                       f"{width}")
    values.append([float(v) if v.strip() else np.nan for v in r[1:]])
  return np.asarray(values, np.float32).reshape(len(values), width - 1)

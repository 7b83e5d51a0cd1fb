"""Library-size statistics (port of ``sisua_tpu/data/utils.py``
``get_library_size``), for numpy arrays, scipy sparse matrices and torch
tensors, with no pandas."""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["get_library_size", "int16_exact"]

# rows per float64 row-sum pass over a tensor: at most 2^25 elements, so the
# float64 copy a pass makes stays ≤ 256 MiB whatever the matrix's size
_SUM_ELEMENTS = 1 << 25


def get_library_size(X):
  """Per-cell library statistics in log space (scVI convention).

  Returns ``(local_mean, local_var)``, each (n_cells, 1) float32: the
  dataset-level mean and (population) variance of log total counts,
  broadcast per cell. A torch tensor stays on its device."""
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
    return mean.expand(n, 1).clone(), var.expand(n, 1).clone()
  total_counts = np.asarray(X.sum(axis=1)).ravel()
  if not np.all(total_counts >= 0):
    warnings.warn(f"Some cell in matrix {X.shape} contains negative counts; "
                  "this yields NaN log counts!")
  log_counts = np.log(total_counts + 1e-8)
  local_mean = np.full((n, 1), np.mean(log_counts), dtype=np.float32)
  local_var = np.full((n, 1), np.var(log_counts), dtype=np.float32)
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

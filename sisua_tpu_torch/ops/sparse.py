"""Sparse host→device transport: CSR triplets over the link, one scatter-add
densify on the device (port of ``sisua_tpu/ops/sparse.py``).

Single-cell count matrices are ~90% zeros. The out-of-core chunks and the
device-cached serving batches of a CSR source ship padded (vals, cols,
rowlen) triplets, 4-8 bytes a nonzero instead of 2-4 bytes a cell, and
rebuild the dense block on the device. The densify is an XLA scatter in
the JAX package, not a Pallas kernel, so here it is one torch
``index_put_`` with accumulation into a zeroed (R·D,) buffer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["col_dtype_for", "worthwhile", "csr_row_triplets", "densify",
           "column_ids"]


def col_dtype_for(n_cols: int):
  """Narrowest dtype that can index every column."""
  return np.uint16 if n_cols <= 65535 else np.int32


def worthwhile(nnz: int, n_rows: int, n_cols: int, val_bytes: int,
               dense_itemsize: int, threshold: float = 0.7) -> bool:
  """Whether the triplet upload beats the dense one by a clear margin."""
  col_bytes = 2 if n_cols <= 65535 else 4
  return nnz * (val_bytes + col_bytes) < threshold * (
      n_rows * n_cols * dense_itemsize)


def csr_row_triplets(indptr: np.ndarray, indices: np.ndarray,
                     data: np.ndarray, rows: Optional[np.ndarray],
                     cap: int, n_rows: int, val_dtype,
                     col_dtype) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """CSR rows as padded (vals[cap], cols[cap], rowlen[n_rows]) triplets.
  ``rows=None`` takes every row in order (a straight pad), padding
  ``rowlen`` with zero-length rows beyond the matrix. Padding entries
  carry value 0, so the device scatter-add leaves the block unchanged."""
  if rows is None:
    total = int(indptr[-1])
    vals = np.zeros(cap, val_dtype)
    cols = np.zeros(cap, col_dtype)
    vals[:total] = data
    cols[:total] = indices
    rowlen = np.zeros(n_rows, np.int32)
    nr = len(indptr) - 1
    rowlen[:nr] = np.diff(indptr)
    return vals, cols, rowlen
  starts = indptr[rows]
  lens = indptr[rows + 1] - starts
  total = int(lens.sum())
  base = np.repeat(starts, lens)
  cum = np.cumsum(lens)
  within = np.arange(total, dtype=np.int64) - np.repeat(cum - lens, lens)
  si = base + within
  vals = np.zeros(cap, val_dtype)
  cols = np.zeros(cap, col_dtype)
  vals[:total] = data[si]
  cols[:total] = indices[si]
  rowlen = np.zeros(n_rows, np.int32)
  rowlen[:len(lens)] = lens
  return vals, cols, rowlen


def column_ids(cols: torch.Tensor) -> torch.Tensor:
  """Column ids as int64. uint16 columns travel as their int16 bits
  (``torch.from_numpy(cols.view(np.int16))``: torch's uint16 supports
  few operations), and are read back unsigned here."""
  c = cols.to(torch.int64)
  return c & 0xFFFF if cols.dtype == torch.int16 else c


def densify(vals: torch.Tensor, cols: torch.Tensor, rowlen: torch.Tensor,
            n_cols: int, out_dtype: torch.dtype, device=None,
            piece: int = 1 << 17) -> torch.Tensor:
  """(len(rowlen), n_cols) block of ``out_dtype`` on ``device`` (the
  triplets' own device when None) from padded triplets, with no host
  synchronization.

  The triplets may lie on the host, pinned for asynchronous copies: they
  cross to the device in pieces of ``piece`` entries, each scattered
  before the next, so the device holds the block and one piece, never the
  whole triplets (the out-of-core double buffer has little room to spare).
  Each entry's row is found in the running row ends; the padding past
  sum(rowlen) belongs to the last row, as ``jnp.repeat(...,
  total_repeat_length=cap)`` pads with the last row id, and its value-0
  entries at column 0 add nothing. The scatter accumulates, since a CSR
  matrix may hold a column twice in a row. Positions are int64, so no
  block is too large to index. int16 accumulates in int16 (exact below
  32,767), bf16 in bf16, as the JAX scatter does."""
  dev = vals.device if device is None else torch.device(device)
  n_rows, cap, n_cols = rowlen.shape[0], vals.shape[0], int(n_cols)
  ends = torch.cumsum(rowlen.to(dev, non_blocking=True), 0,
                      dtype=torch.int64)
  dense = torch.zeros((n_rows * n_cols,), dtype=out_dtype, device=dev)
  for lo in range(0, cap, piece):
    hi = min(cap, lo + piece)
    rows = torch.searchsorted(ends, torch.arange(lo, hi, device=dev),
                              right=True).clamp_max_(n_rows - 1)
    flat = rows * n_cols + column_ids(cols[lo:hi].to(dev, non_blocking=True))
    dense.index_put_((flat,), vals[lo:hi].to(dev, non_blocking=True)
                     .to(out_dtype), accumulate=True)
  return dense.view(n_rows, n_cols)

"""Host-side row gathers in C++ (``csr_gather.cpp``), bound with ctypes: the
port's own copy of ``sisua_tpu/native``.

The library is built with ``g++`` at first use into ``build/kernels/``
beside the package (listed in ``.gitignore``), named by a hash of the
source and flags, under a private temporary name and then renamed, so
that processes building at once never load a half-written file. A failed
build raises: nothing falls back to the numpy versions, which stay here as
the plain reference (``csr_gather_ref``, ``dense_gather_ref``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["build", "load", "library_path", "csr_gather", "dense_gather",
           "csr_gather_ref", "dense_gather_ref"]

_SRC = Path(__file__).resolve().parent / "csr_gather.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
  h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
  root = Path(__file__).resolve().parent.parent.parent
  return root / "build" / "kernels" / f"libsisua_gather_{h.hexdigest()[:16]}.so"


def build() -> Path:
  """Compile the library unless one for this exact source exists."""
  lib = library_path()
  if lib.is_file():
    return lib
  lib.parent.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
                      ".tmp.so")
  proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                       f"{_SRC.name}:\n{proc.stdout}\n{proc.stderr}")
  os.replace(tmp, lib)
  return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
  """Build if needed, load once per process, declare every signature."""
  lib = ctypes.CDLL(str(build()))
  p, n = ctypes.c_void_p, ctypes.c_int64
  for fn in ("csr_gather_f32", "csr_gather_log1p_f32"):
    getattr(lib, fn).argtypes = [p, p, p, p, n, n, p]
    getattr(lib, fn).restype = None
  lib.dense_gather_f32.argtypes = [p, p, n, n, p]
  lib.dense_gather_f32.restype = None
  return lib


def _out(out: Optional[np.ndarray], n_rows: int, n_cols: int) -> np.ndarray:
  """``out``, or a new buffer: the kernels write through its raw pointer,
  so a wrong dtype, shape or layout would be silent memory corruption."""
  if out is None:
    return np.empty((n_rows, n_cols), np.float32)
  if not (out.dtype == np.float32 and out.flags.c_contiguous
          and out.shape == (n_rows, n_cols)):
    raise ValueError(f"out must be C-contiguous float32 {(n_rows, n_cols)}, "
                     f"got {out.dtype} {out.shape}")
  return out


def _rows(rows, n: int) -> np.ndarray:
  rows = np.ascontiguousarray(rows, np.int64)
  if rows.size and (rows.min() < 0 or rows.max() >= n):
    raise IndexError(f"row index out of range for {n} rows")
  return rows


def csr_gather(data, indices, indptr, rows, n_cols: int,
               out: Optional[np.ndarray] = None,
               log1p: bool = False) -> np.ndarray:
  """CSR rows → a dense (len(rows), n_cols) float32 buffer. Any integer or
  float dtypes are taken (scipy defaults to int32 indices): each array is
  coerced to the kernel's float32 / int64 ABI, a copy only when it differs
  (``feeder._CSRSource`` converts once)."""
  data = np.ascontiguousarray(data, np.float32)
  indices = np.ascontiguousarray(indices, np.int64)
  indptr = np.ascontiguousarray(indptr, np.int64)
  rows = _rows(rows, len(indptr) - 1)
  out = _out(out, len(rows), int(n_cols))
  fn = load().csr_gather_log1p_f32 if log1p else load().csr_gather_f32
  fn(data.ctypes.data, indices.ctypes.data, indptr.ctypes.data,
     rows.ctypes.data, len(rows), int(n_cols), out.ctypes.data)
  return out


def dense_gather(src: np.ndarray, rows,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
  """out[r] = src[rows[r]] for a C-contiguous float32 ``src``."""
  if not (src.dtype == np.float32 and src.flags.c_contiguous
          and src.ndim == 2):
    raise ValueError("dense_gather takes a C-contiguous float32 matrix")
  rows = _rows(rows, src.shape[0])
  out = _out(out, len(rows), src.shape[1])
  load().dense_gather_f32(src.ctypes.data, rows.ctypes.data, len(rows),
                          src.shape[1], out.ctypes.data)
  return out


def csr_gather_ref(data, indices, indptr, rows, n_cols: int,
                   log1p: bool = False) -> np.ndarray:
  """Plain numpy version of ``csr_gather`` (row by row; a duplicate
  column keeps its last value, as the C loop does)."""
  out = np.zeros((len(rows), int(n_cols)), np.float32)
  for r, row in enumerate(np.asarray(rows, np.int64)):
    lo, hi = indptr[row], indptr[row + 1]
    vals = np.asarray(data[lo:hi], np.float32)
    out[r, indices[lo:hi]] = np.log1p(vals) if log1p else vals
  return out


def dense_gather_ref(src: np.ndarray, rows) -> np.ndarray:
  return np.take(np.asarray(src, np.float32), np.asarray(rows, np.int64),
                 axis=0)

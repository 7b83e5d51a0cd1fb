"""Host code in C++, bound with ctypes: the row gathers
(``csr_gather.cpp``, the port's own copy of ``sisua_tpu/native``), the
Barnes-Hut t-SNE gradient with its space-partitioning tree (``tsne.cpp``,
sklearn's ``_quad_tree.pyx`` and ``_barnes_hut_tsne.pyx``) and the
LARS-Lasso path on a Gram matrix (``lars.cpp``, sklearn's
``_lars_path_solver``), the last two parallel over points or targets
with OpenMP.

Each library is built with ``g++`` at first use into ``build/kernels/``
beside the package (listed in ``.gitignore``), named by a hash of the
source and flags, under a private temporary name and then renamed, so
that processes building at once never load a half-written file. A failed
build raises: nothing falls back to a Python version. The numpy gathers
stay here as the plain reference (``csr_gather_ref``,
``dense_gather_ref``); the t-SNE and LARS tests hold the libraries to
sklearn.
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
           "csr_gather_ref", "dense_gather_ref", "tsne_gradient",
           "lars_lasso_gram", "get_lib", "native_available"]

_DIR = Path(__file__).resolve().parent
_FLAGS = ("-O3", "-shared", "-fPIC")
# name → (source, flags, library stem)
_LIBRARIES = {
    "gather": ("csr_gather.cpp", _FLAGS, "libsisua_gather"),
    "tsne": ("tsne.cpp", _FLAGS + ("-fopenmp",), "libsisua_tsne"),
    "lars": ("lars.cpp", _FLAGS + ("-fopenmp",), "libsisua_lars"),
    # no fused multiply-add: the criterion's sums round as numpy's
    "gbtree": ("gbtree.cpp", _FLAGS + ("-ffp-contract=off",),
               "libsisua_gbtree"),
}


def library_path(name: str = "gather") -> Path:
  src, flags, stem = _LIBRARIES[name]
  h = hashlib.sha256(" ".join(flags).encode() + (_DIR / src).read_bytes())
  root = _DIR.parent.parent
  return root / "build" / "kernels" / f"{stem}_{h.hexdigest()[:16]}.so"


def build(name: str = "gather") -> Path:
  """Compile the library unless one for this exact source exists."""
  lib = library_path(name)
  if lib.is_file():
    return lib
  src, flags, _ = _LIBRARIES[name]
  lib.parent.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
                      ".tmp.so")
  proc = subprocess.run(["g++", *flags, str(_DIR / src), "-o", str(tmp)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                       f"{src}:\n{proc.stdout}\n{proc.stderr}")
  os.replace(tmp, lib)
  return lib


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_D, _F = ctypes.c_double, ctypes.c_float
_LARS = [_P, _P, _I64, _I64, _I64, _D, _I64, _D, _I32, _P, _P, _P, _P]
# name → {function: (argtypes, restype)}
_SIGNATURES = {
    "gather": {"csr_gather_f32": ([_P, _P, _P, _P, _I64, _I64, _P], None),
               "csr_gather_log1p_f32": ([_P, _P, _P, _P, _I64, _I64, _P],
                                        None),
               "dense_gather_f32": ([_P, _P, _I64, _I64, _P], None)},
    "tsne": {"tsne_bh_gradient": ([_P, _P, _P, _P, _I64, _I32, _F, _I32,
                                   _I32, _I32, _P], _F)},
    "lars": {"lars_lasso_gram_f32": (_LARS, None),
             "lars_lasso_gram_f64": (_LARS, None)},
    "gbtree": {"gbtree_build": ([_P, _I64, _I64, _P, _P, _P, _I64,
                                 ctypes.c_uint32, _I64] + [_P] * 8, _I64)},
}


@functools.lru_cache(maxsize=None)
def load(name: str = "gather") -> ctypes.CDLL:
  """Build if needed, load once per process, declare every signature."""
  lib = ctypes.CDLL(str(build(name)))
  for fn, (argtypes, restype) in _SIGNATURES[name].items():
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = restype
  return lib


def get_lib() -> Optional[ctypes.CDLL]:
  """The gathers' library, built and loaded, or None where it does not
  build or load (the JAX package's ``get_lib``). The gathers themselves
  raise then: nothing falls back to numpy."""
  try:
    return load("gather")
  except (OSError, RuntimeError):
    return None


def native_available() -> bool:
  """Whether the gathers' g++ library builds and loads."""
  return get_lib() is not None


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


def tsne_gradient(val_P, pos, neighbors, indptr, theta: float = 0.5,
                  dof: int = 1, compute_error: bool = True,
                  num_threads: Optional[int] = None):
  """sklearn's ``_barnes_hut_tsne.gradient``: the t-SNE forces on ``pos``
  ((n, 2) or (n, 3) float32) from the CSR joint probabilities (float32
  ``val_P``, int64 ``neighbors``/``indptr``), before the factor
  2(dof + 1)/dof, on ``num_threads`` OpenMP threads (None: OpenMP's
  default team, which ``OMP_NUM_THREADS`` and threadpoolctl set, as for
  sklearn). Returns ``(error, forces)``; the error (the KL divergence) is
  NaN unless ``compute_error``."""
  pos = np.ascontiguousarray(pos, np.float32)
  val_P = np.ascontiguousarray(val_P, np.float32)
  neighbors = np.ascontiguousarray(neighbors, np.int64)
  indptr = np.ascontiguousarray(indptr, np.int64)
  n, nd = pos.shape
  if nd not in (2, 3):
    raise ValueError(f"the tree takes 2 or 3 dimensions, got {nd}")
  if len(indptr) != n + 1 or len(val_P) != len(neighbors) \
      or indptr[0] != 0 or indptr[-1] != len(neighbors) \
      or np.any(np.diff(indptr) < 0):
    raise ValueError("val_P, neighbors and indptr are not a CSR matrix "
                     f"over {n} points")
  if neighbors.size and (neighbors.min() < 0 or neighbors.max() >= n):
    raise IndexError(f"neighbour index out of range for {n} points")
  forces = np.empty((n, nd), np.float32)
  error = load("tsne").tsne_bh_gradient(
      val_P.ctypes.data, pos.ctypes.data, neighbors.ctypes.data,
      indptr.ctypes.data, n, nd, float(theta), int(dof), int(compute_error),
      int(num_threads or 0), forces.ctypes.data)
  if error == -1.0:
    raise RuntimeError("t-SNE tree lost points (non-finite positions?)")
  return float(error), forces


def lars_lasso_gram(gram, xy, n_samples: int, alpha_min: float,
                    max_iter: int = 500, eps: float = float(
                        np.finfo(float).eps),
                    num_threads: Optional[int] = None):
  """sklearn's LARS-Lasso path (``lars_path_gram(method='lasso',
  return_path=False)``) of each row of ``xy`` ((n_targets, k)) on the
  (k, k) ``gram``, in their dtype (float32 or float64). Returns
  ``(coef (n_targets, k), alpha (n_targets,), n_iter (n_targets,),
  active (n_targets, k), -1 past each path's active set)``."""
  gram = np.asarray(gram)
  dtype = np.float32 if gram.dtype == np.float32 else np.float64
  gram = np.ascontiguousarray(gram, dtype)
  xy = np.ascontiguousarray(xy, dtype)
  k = gram.shape[0]
  if gram.shape != (k, k) or xy.ndim != 2 or xy.shape[1] != k:
    raise ValueError(f"gram {gram.shape} and xy {xy.shape} do not match")
  t = xy.shape[0]
  coef = np.empty((t, k), dtype)
  alpha = np.empty(t, dtype)
  n_iter = np.empty(t, np.int64)
  active = np.empty((t, k), np.int64)
  fn = (load("lars").lars_lasso_gram_f32 if dtype == np.float32
        else load("lars").lars_lasso_gram_f64)
  fn(gram.ctypes.data, xy.ctypes.data, t, k, int(n_samples),
     float(alpha_min), int(max_iter), float(eps),
     int(num_threads or 0), coef.ctypes.data,
     alpha.ctypes.data, n_iter.ctypes.data, active.ctypes.data)
  return coef, alpha, n_iter, active

"""Build and bind the port's CUDA kernels: nvcc → shared library → ctypes.

The sources in ``sisua_tpu_torch/csrc`` have a plain ``extern "C"``
interface and include no PyTorch header, so ``nvcc`` builds them in
seconds (a source that includes PyTorch's headers takes minutes, and
``torch.utils.cpp_extension.load`` needs ``ninja``). The library is built at
first use into ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed
source builds anew and an unchanged one is reused. The compiler's
``-Xptxas -v`` report (registers, spills) is kept beside it as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["build", "load", "library_path", "nvcc_command"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("zinb.cu",)
# FMA contraction stays on (nvcc's default): the kernels pass every card
# case at the same tolerances with and without --fmad=false, and its
# fused multiply-adds save instructions where the kernels are short of
# issue slots (tools/zinb_kernel_ab.py)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _build_dir() -> Path:
  return _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
  home = os.environ.get("CUDA_HOME")
  for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
      Path("/usr/local/cuda/bin/nvcc")]:
    if cand.is_file():
      return str(cand)
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built")
  return found


def _digest() -> str:
  h = hashlib.sha256(" ".join(_FLAGS).encode())
  for name in _SOURCES:
    h.update(name.encode())
    h.update((_CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def library_path() -> Path:
  return _build_dir() / f"libsisua_kernels_{_digest()}.so"


def nvcc_command(out: Path, nvcc: str = "nvcc") -> list:
  return [nvcc, *_FLAGS, "-o", str(out),
          *(str(_CSRC / name) for name in _SOURCES)]


def build() -> Path:
  """Compile the kernels unless a library for these exact sources exists.
  Writes to a private temporary name and renames, so concurrent builds
  never load a half-written file."""
  lib = library_path()
  if lib.is_file():
    return lib
  lib.parent.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
  proc = subprocess.run(nvcc_command(tmp, _nvcc()), capture_output=True,
                        text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                       f"{proc.stdout}\n{proc.stderr}")
  lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
  os.replace(tmp, lib)
  return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of csrc/zinb.cu's entry points
_SIGNATURES: Dict[str, tuple] = {
    "sisua_zinb_rowsum_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L,
                              _I, _I, _I, _I, _P),
    "sisua_zinb_rowsum_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _L, _L, _L, _I, _I, _I, _I, _P),
    # the bf16 modes: + the bf16-operand mask (+ the bf16-write flag)
    "sisua_zinb_rowsum_fwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _L,
                                   _L, _I, _I, _I, _I, _I, _P),
    "sisua_zinb_rowsum_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                                   _P),
}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
  """Build if needed, load once per process, declare every signature."""
  lib = ctypes.CDLL(str(build()))
  for name, argtypes in _SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
  return lib

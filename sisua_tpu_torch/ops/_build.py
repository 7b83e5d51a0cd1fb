"""Build and bind the port's CUDA kernels: nvcc → shared library → ctypes.

The sources in ``sisua_tpu_torch/csrc`` have a plain ``extern "C"``
interface and include no PyTorch header, so ``nvcc`` builds them in
seconds (a source that includes PyTorch's headers takes minutes, and
``torch.utils.cpp_extension.load`` needs ``ninja``). Each source compiles
to an object in its own ``nvcc``, all started together, and one library
links them. It is built at first use into ``build/kernels/`` beside the
package (listed in ``.gitignore``), named by a hash of the sources, the
headers they include and the flags, so a changed source builds anew and an
unchanged one is reused. The compiler's ``-Xptxas -v`` report (registers,
spills) is kept beside it as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["build", "load", "library_path", "nvcc_commands"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("zinb.cu", "probe.cu")
_HEADERS = ("tile_ring.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# FMA contraction stays on (nvcc's default): the kernels pass every card
# case at the same tolerances with and without --fmad=false, and its
# fused multiply-adds save instructions where the kernels are short of
# issue slots (tools/zinb_kernel_ab.py)
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v")


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
  for name in _SOURCES + _HEADERS:
    h.update(name.encode())
    h.update((_CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def library_path() -> Path:
  return _build_dir() / f"libsisua_kernels_{_digest()}.so"


def nvcc_commands(out: Path, nvcc: str = "nvcc") -> Tuple[List[list], list]:
  """One compile command per source (objects beside ``out``) and the
  command that links them into ``out``."""
  objs = [out.with_name(f"{out.stem}.{Path(src).stem}.o")
          for src in _SOURCES]
  compiles = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
              for src, obj in zip(_SOURCES, objs)]
  return compiles, [nvcc, *_ARCH, "-shared", "-o", str(out),
                    *(str(o) for o in objs)]


def build() -> Path:
  """Compile the kernels unless a library for these exact sources exists:
  every source at once, then one link. Writes to a private temporary name
  and renames, so concurrent builds never load a half-written file."""
  lib = library_path()
  if lib.is_file():
    return lib
  lib.parent.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
  compiles, link = nvcc_commands(tmp, _nvcc())
  procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for cmd in compiles]
  outputs = [p.communicate()[0] for p in procs]
  report = "".join(outputs)
  failed = [p.returncode for p in procs if p.returncode != 0]
  if not failed:
    proc = subprocess.run(link, capture_output=True, text=True)
    report += proc.stdout + proc.stderr
    failed = [proc.returncode] if proc.returncode != 0 else []
  for cmd in compiles:
    Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
  if failed:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed ({failed[0]}):\n{report}")
  lib.with_suffix(".log").write_text(report)
  os.replace(tmp, lib)
  return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of the entry points of csrc/zinb.cu and csrc/probe.cu
_SIGNATURES: Dict[str, tuple] = {
    # x, θ operand, logits, gate, out, partial; M, B, D; member strides
    # (x, θ, logits, gate); row strides (θ, logits, gate); vec, tiles per
    # chunk, chunks, constrained; stream
    "sisua_zinb_rowsum_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                              _L, _L, _L, _L, _L, _I, _I, _I, _I, _P),
    # x, θ operand, logits, gate, cotangent, three fields, partial; M, B, D;
    # member strides; row strides; vec, rows per chunk, chunks,
    # constrained; stream
    "sisua_zinb_rowsum_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I,
                              _I, _P),
    # the bf16 modes: + the bf16-operand mask (+ the bf16-write flag)
    "sisua_zinb_rowsum_fwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                                   _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                                   _I, _P),
    "sisua_zinb_rowsum_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _L, _L, _L, _L, _L, _L, _L, _I,
                                   _I, _I, _I, _I, _I, _P),
    # csrc/probe.cu: x, a, b, c, out, partial, B, D, vec, tiles per chunk,
    # chunks, n_fma or the lgamma variant, stream
    "sisua_elemwise_probe": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P),
    "sisua_lgamma_probe": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
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

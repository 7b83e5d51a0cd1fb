"""Speed-of-light probes of the ZINB forward's tiling: CUDA kernels, plain
versions and the timing run (port of ``benchmarks/kernel_probe.py``).

Two kernels, written by hand in CUDA C++ (``csrc/probe.cu``):

* ``elemwise_probe`` replaces ``_elemwise_probe_kernel``
  (``benchmarks/kernel_probe.py:83``): per row, Σ over the D columns of
  ``acc = x`` followed by ``n_fma`` chained ``acc = acc·a + b``.
* ``lgamma_probe`` replaces ``_lgamma_probe_kernel``
  (``benchmarks/kernel_probe.py:131``): per row, Σ of ``lgamma(x + a + 1)``
  by Lanczos, by Stirling (the JAX package's two in-kernel forms,
  ``zinb_pallas.py:52`` and ``:69``), or by CUDA's ``lgammaf``, which the
  ZINB kernels use (the port's counterpart of ``_kernel_lgamma()``).

Both run the ZINB forward's launch plan, tile loader and ordered sums
(``ops/zinb.py::_launch_plan``, ``csrc/tile_ring.cuh``) and read all four
(B, D) float32 streams, 16 bytes an element, so their times price the
production tiling: its ceiling for the bytes (``n_fma`` 1), the FMA pipe
(``n_fma`` 256: 32 flop/byte, above the H100's ~20 flop/byte ridge; 64 is
still below it) and each lgamma. ``run_probe`` times them beside the
production kernels.

On CPU tensors the wrappers run the plain versions (``elemwise_probe_ref``,
``lgamma_probe_ref``); a CUDA tensor launches the kernel or raises. Only
the tests and ``chip_smoke.py`` call them.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from . import zinb as tz

__all__ = ["elemwise_probe", "lgamma_probe", "elemwise_probe_ref",
           "lgamma_probe_ref", "lgamma_lanczos", "lgamma_stirling",
           "run_probe", "probe_operands", "launches", "reset_launches",
           "N_FMA", "LGAMMA"]

#: the n_fma instances csrc/probe.cu builds
N_FMA = (1, 64, 256)
#: lgamma_probe's variants, in the kernel's numbering
LGAMMA = ("lanczos", "stirling", "lgammaf")

# launch counts of the two kernels, raised only where a kernel is launched
launches = {"elemwise_probe": 0, "lgamma_probe": 0}

_LANCZOS_G = 7.0
_LANCZOS = (0.99999999999980993, 676.5203681218851, -1259.1392167224028,
            771.32342877765313, -176.61502916214059, 12.507343278686905,
            -0.13857109526572012, 9.9843695780195716e-6,
            1.5056327351493116e-7)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def reset_launches() -> None:
  for k in launches:
    launches[k] = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def lgamma_lanczos(x: torch.Tensor) -> torch.Tensor:
  """lgamma for x > 0, Lanczos g = 7, every series term written in x (the
  JAX ``_lgamma_lanczos``: (x − 1) + 1 would round a tiny x to 0)."""
  a = torch.full_like(x, _LANCZOS[0])
  for i, c in enumerate(_LANCZOS[1:]):
    a = a + c / (x + float(i))
  t = x + (_LANCZOS_G - 0.5)
  return _HALF_LOG_2PI + (x - 0.5) * torch.log(t) - t + torch.log(a)


def lgamma_stirling(x: torch.Tensor) -> torch.Tensor:
  """lgamma for x > 0: Stirling at y = x + 8 less log Π_{k<8}(x + k), the
  factors scaled by 1/y (the JAX ``_lgamma_stirling``)."""
  y = x + 8.0
  inv = 1.0 / y
  p = ((x * inv) * ((x + 1.0) * inv) * ((x + 2.0) * inv)
       * ((x + 3.0) * inv) * ((x + 4.0) * inv) * ((x + 5.0) * inv)
       * ((x + 6.0) * inv) * ((x + 7.0) * inv))
  inv2 = inv * inv
  series = inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 * (1.0 / 1260.0)))
  return (y - 8.5) * torch.log(y) - y + _HALF_LOG_2PI - torch.log(p) + series


_LGAMMA_REF = {"lanczos": lgamma_lanczos, "stirling": lgamma_stirling,
               "lgammaf": torch.lgamma}


def elemwise_probe_ref(x, a, b, c, n_fma: int) -> torch.Tensor:
  """Plain version: the kernel's chain unfused, c folded in as c·0."""
  acc = x
  for _ in range(int(n_fma)):
    acc = acc * a + b
  return torch.sum(acc + c * 0.0, -1)


def lgamma_probe_ref(x, a, b, c, which: str) -> torch.Tensor:
  v = _LGAMMA_REF[which](x + a + 1.0)
  return torch.sum((v + c * 0.0) + b * 0.0, -1)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------
def _check(ops) -> tuple:
  x = ops[0]
  for t in ops:
    if not t.is_cuda or t.device != x.device:
      raise ValueError(f"the probe kernels need CUDA tensors on one device, "
                       f"got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
      raise TypeError("the probe kernels take contiguous float32 operands")
    if t.shape != x.shape or t.dim() != 2 or not t.numel():
      raise ValueError(f"operands must share one non-empty (B, D) shape, "
                       f"got {tuple(t.shape)} and {tuple(x.shape)}")
  b, d = x.shape
  if b >= 2 ** 31 or d >= 2 ** 31:
    raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int32 "
                     "row and column indices")
  return b, d


def _launch(name: str, entry: str, ops, arg: int,
            out: Optional[torch.Tensor]) -> torch.Tensor:
  from . import _build
  b, d = _check(ops)
  dev = ops[0].device
  plan = tz._launch_plan(b, d, [d] * 3, [t.data_ptr() for t in ops],
                         tz._sm_count(dev))
  if out is None:
    out = tz._scratch((b,), dev)
  elif out.shape != (b,) or out.dtype != torch.float32 or \
      out.device != dev or not out.is_contiguous():
    raise ValueError("out must be a contiguous float32 (B,) tensor on the "
                     "operands' device")
  partial = (None if plan.fwd_chunks == 1
             else tz._scratch((b, plan.fwd_chunks), dev))
  tz._launch(dev, name, getattr(_build.load(), entry),
             *(t.data_ptr() for t in ops), out.data_ptr(),
             tz._ptr(partial), b, d, int(plan.vec), plan.fwd_tiles,
             plan.fwd_chunks, int(arg))
  launches[name] += 1
  return out


def elemwise_probe(x, a, b, c, n_fma: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
  """(B,) row sums of the ``n_fma``-FMA chain (1, 64 or 256). ``out``: a
  preallocated result on the card."""
  if int(n_fma) not in N_FMA:
    raise ValueError(f"n_fma must be one of {N_FMA}, got {n_fma}")
  if tz._launches_kernel(x):
    return _launch("elemwise_probe", "sisua_elemwise_probe", (x, a, b, c),
                   int(n_fma), out)
  return elemwise_probe_ref(x, a, b, c, n_fma)


def lgamma_probe(x, a, b, c, which: str,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
  """(B,) row sums of lgamma(x + a + 1) by ``which`` ('lanczos',
  'stirling' or 'lgammaf')."""
  if which not in LGAMMA:
    raise ValueError(f"which must be one of {LGAMMA}, got {which!r}")
  if tz._launches_kernel(x):
    return _launch("lgamma_probe", "sisua_lgamma_probe", (x, a, b, c),
                   LGAMMA.index(which), out)
  return lgamma_probe_ref(x, a, b, c, which)


# --------------------------------------------------------------------------
# The timing run
# --------------------------------------------------------------------------
def probe_operands(B: int, D: int, device, seed: int = 0):
  """x ~ Poisson(2), θ = exp(0.5·N), logits N, gate N − 2, each (B, D)
  float32, made on ``device`` (``benchmarks/kernel_probe.py:44-52``)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  n = lambda: torch.randn((B, D), generator=gen, device=device)  # noqa: E731
  x = torch.poisson(torch.full((B, D), 2.0, device=device), generator=gen)
  return x, torch.exp(n() * 0.5), n(), n() - 2.0


# f32 operations an element of each variant (an FMA as 2, every other
# arithmetic operation, comparison, log and divide as 1, an lgammaf as 20,
# as chip_smoke.py counts the ZINB kernels), plus the mask and the sum
_LGAMMA_OPS = {"lanczos": 33, "stirling": 36, "lgammaf": 20}


def _variants(x, r, lg, gt, outs):
  """name → (launch, f32 operations an element or None for the ZINB
  kernels, bytes per call)."""
  b, d = x.shape
  g = torch.ones((b,), device=x.device)
  need = (True, True, True)
  read = 4 * x.numel() * 4
  out = {}
  for n in N_FMA:
    name = "sol_mem" if n == 1 else f"sol_fma{n}"
    out[name] = (lambda n=n, o=outs[name]: elemwise_probe(x, r, lg, gt, n,
                                                          out=o),
                 2 * n + 2 + 2, read + 4 * b)
  for which in LGAMMA:
    name = f"lg_{which}"
    out[name] = (lambda w=which, o=outs[name]: lgamma_probe(x, r, lg, gt, w,
                                                            out=o),
                 2 + _LGAMMA_OPS[which] + 4 + 2, read + 4 * b)
  out["zinb_fwd"] = (lambda: tz._fwd_launch(x, r, lg, gt, True), None,
                     read + 4 * b)
  out["zinb_fwdbwd"] = (
      lambda: (tz._fwd_launch(x, r, lg, gt, True),
               tz._bwd_launch(x, r, lg, gt, g, True, need)),
      None, 2 * (read + 4 * b) + 3 * x.numel() * 4)
  return out


def run_probe(B: int = 1024, D: int = 33_000, reps: int = 3,
              launches: int = 32, ops: Optional[tuple] = None,
              hbm_bytes_per_s: float = 3.35e12,
              f32_ops_per_s: float = 67e12) -> List[Dict]:
  """Time every variant on the card: ``launches`` back-to-back calls
  between two CUDA events into preallocated outputs, ``reps`` passes in
  turns over all variants, the median per variant (the TPU script's
  interleaved median; its ``lax.scan`` window and carry perturbation kept
  XLA from hoisting the call, which direct launches cannot suffer). Rows:
  ``variant``, ``ms`` per call, ``gelem_per_s``, ``bound_ms`` (the larger
  of the bytes at ``hbm_bytes_per_s`` and, where counted, the operations
  at ``f32_ops_per_s``), ``bound_by`` and ``share`` of the bound; then the
  ``derived`` row: the FMA pass's cost from the compute-bound
  ``sol_fma256`` against ``sol_mem``, (t256 − t_mem)/255, and each lgamma
  and ZINB variant's cost in those FMA passes, as the TPU script derives
  them from ``sol_fma64``; the 64-FMA estimate is kept beside it (below
  the ridge, it collapses toward the noise)."""
  x, r, lg, gt = ops if ops is not None else probe_operands(
      B, D, torch.device("cuda"))
  b, d = x.shape
  elems = b * d
  outs = {n: torch.empty((b,), device=x.device)
          for n in ("sol_mem", "sol_fma64", "sol_fma256", "lg_lanczos",
                    "lg_stirling", "lg_lgammaf")}
  variants = _variants(x, r, lg, gt, outs)
  for fn, _, _ in variants.values():  # warm-up
    fn()
  torch.cuda.synchronize()
  times: Dict[str, List[float]] = {k: [] for k in variants}
  for _ in range(int(reps)):
    for name, (fn, _, _) in variants.items():
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(int(launches)):
        fn()
      end.record()
      end.synchronize()
      times[name].append(start.elapsed_time(end) / launches)
  nz = int((x > 0).sum())
  zero_ops, count_ops = (30, 95)  # chip_smoke.OPS["fwd"]
  bwd_zero, bwd_count = (55, 110)  # chip_smoke.OPS["bwd"]
  rows = []
  med = {k: statistics.median(v) for k, v in times.items()}
  for name, (_, per_elem, nbytes) in variants.items():
    if per_elem is not None:
      n_ops = per_elem * elems
    elif name == "zinb_fwd":
      n_ops = (elems - nz) * zero_ops + nz * count_ops
    else:
      n_ops = ((elems - nz) * (zero_ops + bwd_zero)
               + nz * (count_ops + bwd_count))
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = n_ops / f32_ops_per_s * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    rows.append({"variant": name, "ms": med[name], "ms_passes": times[name],
                 "gelem_per_s": elems / (med[name] * 1e-3) / 1e9,
                 "gb_per_s": nbytes / (med[name] * 1e-3) / 1e9,
                 "bound_ms": bound, "bound_by": by,
                 "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
                 "share": bound / med[name]})
  t_mem = med["sol_mem"]
  derived = {"variant": "derived"}
  for n in (64, 256):
    t_fma = (med[f"sol_fma{n}"] - t_mem) / (n - 1)
    derived[f"fma_pass_ms_from_{n}"] = t_fma
    derived[f"f32_gflops_from_{n}"] = (2.0 * elems / (t_fma * 1e-3) / 1e9
                                       if t_fma > 0 else float("nan"))
  t_fma = derived["fma_pass_ms_from_256"]
  derived["hbm_bound_gelem_s"] = elems / (t_mem * 1e-3) / 1e9
  for name in med:
    if name.startswith(("lg_", "zinb_")):
      derived[f"{name}_fma_equiv"] = ((med[name] - t_mem) / t_fma
                                      if t_fma > 0 else float("nan"))
  rows.append(derived)
  return rows

"""Fused ZINB/NB log-likelihood row reduction: CUDA kernels + plain versions.

Port of ``sisua_tpu/ops/zinb_pallas.py``. Two kernels, written by hand in
CUDA C++ (``csrc/zinb.cu``), carry the NB/ZINB likelihoods of SCVI and of
the SISUA family's 'zinb' and 'nb' heads:

* ``zinb_rowsum_fwd`` replaces the Pallas forward ``_make_kernel``
  (``sisua_tpu/ops/zinb_pallas.py:172``): per-row Σ over genes of the
  ZINB log-pmf. Its bytes bound is 4 f32 reads per element. With one
  element per thread it was bound by instruction issue instead: most
  warps of 32 genes hold a nonzero count and ran both the zero path and
  the lgamma path. Each warp now computes the zero path for 4 columns a
  lane and runs the lgamma terms on full warps of queued nonzero
  elements, carried across tiles (~70% of the bytes bound at 512 ×
  33,000 on the H100, now bound by bytes).
* ``zinb_rowsum_bwd`` replaces the Pallas backward ``_make_bwd_kernel``
  (``zinb_pallas.py:339``): the three analytic gradient fields times the
  row cotangent. Its bytes bound is 4 reads + up to 3 writes per element
  (~75% of it reached). Its digamma path is queued per tile the same way,
  and the results return to their elements so the stores stay coalesced.
  Per-gene (1, D) operands get their gradient summed over rows in the
  kernel (chunk sums + an ordered second pass, no float atomics), never a
  (B, D) field; a field whose input needs no gradient is not written.

Both stream 128-column tiles with ``cp.async``: 16-byte copies where every
row start is 16-byte aligned, 4-byte copies otherwise.
``_launch_plan`` decides the copy width, the grids and the scratch from the
shapes, strides and addresses; it is plain Python so the CPU tests reach it.

Each kernel has its plain PyTorch version beside it (``_rowsum_ref``;
``_zinb_grads_elem`` + ``_unbroadcast``), ported one to one from the JAX
module, and a launch counter (``launches``). Dispatch is by the tensor's
device alone: CPU tensors take the plain version; a CUDA tensor launches
the kernel or raises — nothing falls back.

The TPU kernels' two bf16 modes (``*_bf16`` entry points of the library):
  * bf16 operands: a (B, D) θ operand, logits or gate may be bf16 (the
    objective casts them under ``SISUA_TPU_FWD_OPERANDS=bf16``); ``x`` and
    per-gene rows stay float32 (a bf16 per-gene row is widened here, its
    gradient reduced in f32 and cast back). The math is float32 on the
    widened values, and every gradient comes back in its primal's dtype.
  * bf16 gradient writes: with any bf16 operand every (B, D) field is
    written bf16, as JAX's ``_zinb_bwd``; with float32 operands
    ``SISUA_TPU_BWD_WRITES=bf16`` selects them and the field is widened
    back to float32 for autograd. The port's default stays 'f32': the JAX
    package's 'bf16' default was set by a TPU A/B, and no card measurement
    has decided it yet.
The plain versions take the same inputs and round where the kernels do.

The member axis (``jax.vmap`` of the TPU kernels: Pallas's batching rule
adds a grid axis). Under ``torch.func.vmap`` the ``vmap`` rules of
``_ZinbRowsum`` and of its backward, an operator of its own so that
``vmap(grad(…))`` batches it too, hand all M members to one launch of each
kernel (``members=M``: grid z, a member stride per operand, 0 for an
operand the members share, such as an ensemble's shared counts). The
plain versions broadcast over the same axis. One member gives the bits of
the launch without the axis.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Sequence

import torch

__all__ = ["zinb_log_prob_rowsum", "nb_log_prob_rowsum",
           "zinbd_log_prob_rowsum", "nbd_log_prob_rowsum",
           "kernels_available", "bf16_operands_ok", "launches",
           "reset_launches"]

_EXP_CLIP = 15.0

# Effective −∞ for the no-inflation gate of the NB heads: far below any
# reachable NB log-prob at zero, and exact in the stable log-sigmoid /
# logaddexp forms (logaddexp(−1e30, nb0) ≡ nb0).
_NB_GATE = -1e30

# columns per warp tile and warps per block (csrc/zinb.cu kTile, kWarps)
_TILE = 128
_WARPS = 8
# blocks the launch plan aims for on each SM: a few waves of resident blocks
_BLOCKS_PER_SM = 16
# fewest rows a backward block walks, so its copy ring has a row in flight
# (more would lengthen each block's chain of loads at small D)
_BWD_MIN_ROWS = 2
_MAX_GRID_Y = 65535

# launch counts of the two kernels, raised only where a kernel is launched
launches = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}


def reset_launches() -> None:
  for k in launches:
    launches[k] = 0


def bf16_operands_ok(b: int) -> bool:
  """Whether the JAX package would run a batch of ``b`` rows in its
  bf16-operand mode (``zinb_pallas.bf16_operands_ok``): its Pallas tiles
  need a 16-row block (``SISUA_TPU_BLOCK_B`` when it divides the batch and
  is a multiple of 16). The port's kernels mask ragged rows and take any
  ``b``; the objective asks this so that the same batch gets the same
  rounding in both packages."""
  bb = int(os.environ.get("SISUA_TPU_BLOCK_B", 8))
  bb = bb if bb > 0 and b % bb == 0 else 8
  if bb % 16:
    bb = 16
  return b % bb == 0


def _bf16_writes() -> bool:
  """``SISUA_TPU_BWD_WRITES=bf16``: bf16 (B, D) gradient writes for
  float32 operands ('f32', the port's default, otherwise)."""
  return os.environ.get("SISUA_TPU_BWD_WRITES", "f32") == "bf16"


def _write_dtype(params) -> torch.dtype:
  """The dtype the (B, D) gradient fields are written in: bf16 when any
  operand is bf16 (JAX's ``_zinb_bwd``), else the SISUA_TPU_BWD_WRITES
  policy."""
  if any(p.dtype == torch.bfloat16 for p in params) or _bf16_writes():
    return torch.bfloat16
  return torch.float32


def _widen(a: torch.Tensor) -> torch.Tensor:
  """A bf16 operand as float32 (what the kernels do in registers); any
  other dtype as it is."""
  return a.to(torch.float32) if a.dtype == torch.bfloat16 else a


def kernels_available(t: torch.Tensor) -> bool:
  """Whether ``t`` would reach the CUDA kernels (the port's counterpart of
  ``pallas_available``): true exactly for a CUDA tensor."""
  return t.is_cuda


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# --------------------------------------------------------------------------
def _log_sigmoid(x):
  return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-torch.abs(x)))


def _softplus(x):
  return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _theta(count_raw, constrained: bool):
  if constrained:
    return torch.clamp_min(count_raw, 1e-8)
  return torch.exp(torch.clamp(count_raw, -_EXP_CLIP, _EXP_CLIP))


def _zinb_elem(x, count_raw, logits, gate, constrained: bool):
  r = _theta(count_raw, constrained)
  log_p = _log_sigmoid(logits)
  log_1mp = _log_sigmoid(-logits)
  # lgamma(x+r) − lgamma(r) is pure cancellation for huge r: asymptotic
  # x·log r + x(x−1)/2r above 1e6
  lg_diff = torch.where(r > 1e6,
                        x * torch.log(r) + x * (x - 1.0) / (2.0 * r),
                        torch.lgamma(x + r) - torch.lgamma(r))
  nb = lg_diff - torch.lgamma(x + 1.0) + r * log_1mp + x * log_p
  nb0 = r * log_1mp  # NB log-prob at x=0 (lgamma terms cancel)
  log_pi = _log_sigmoid(gate)
  log_1mpi = _log_sigmoid(-gate)
  at_zero = torch.logaddexp(log_pi, log_1mpi + nb0)
  return torch.where(x <= 0.0, at_zero, log_1mpi + nb)


def _rowsum_ref(x, count_raw, logits, gate, constrained: bool):
  """Plain forward; bf16 operands are widened first (float32 math)."""
  return torch.sum(_zinb_elem(x, _widen(count_raw), _widen(logits),
                              _widen(gate), constrained), -1)


def _digamma_diff(r, x):
  """ψ(x+r) − ψ(r) without cancellation, r > 0, x ≥ 0: every term is
  proportional to x, so x = 0 gives exactly 0."""
  s = sum(x / ((r + k) * (x + r + k)) for k in range(6))
  y1 = r + 6.0
  inv1 = 1.0 / y1
  inv2 = 1.0 / (x + y1)
  di = -x * inv1 * inv2
  si = inv1 + inv2
  i1s = inv1 * inv1
  i2s = inv2 * inv2
  out = (torch.log1p(x * inv1)
         - 0.5 * di
         - di * si * (1.0 / 12.0
                      - (1.0 / 120.0) * (i1s + i2s)
                      + (1.0 / 252.0) * (i1s * i1s + i1s * i2s + i2s * i2s)))
  return out + s


def _zinb_grads_elem(x, count_raw, logits, gate, constrained: bool):
  """Analytic per-element gradients of the ZINB log-pmf w.r.t.
  (count_raw, logits, gate)."""
  r = _theta(count_raw, constrained)
  if constrained:
    dr_dcr = (count_raw >= 1e-8).to(x.dtype)
  else:
    dr_dcr = r * ((count_raw > -_EXP_CLIP)
                  & (count_raw < _EXP_CLIP)).to(x.dtype)
  sig_l = torch.sigmoid(logits)
  sig_nl = torch.sigmoid(-logits)
  log_1mp = -_softplus(logits)
  # x > 0: d nb / d r mirrors the forward's large-r switch
  dig = torch.where(r > 1e6, x / r - x * (x - 1.0) / (2.0 * r * r),
                    _digamma_diff(r, x))
  dpos_dr = dig + log_1mp
  dpos_dl = x * sig_nl - r * sig_l
  sig_g = torch.sigmoid(gate)
  sig_ng = torch.sigmoid(-gate)
  dpos_dg = -sig_g
  # x == 0: lp = logaddexp(logσ(γ), logσ(−γ) + nb0)
  nb0 = r * log_1mp
  a = -_softplus(-gate)
  b = -_softplus(gate) + nb0
  wb = torch.exp(b - torch.logaddexp(a, b))  # posterior weight of NB arm
  dzero_dr = wb * log_1mp
  dzero_dl = -wb * r * sig_l
  dzero_dg = (1.0 - wb) * sig_ng - wb * sig_g
  iszero = x <= 0.0
  return (torch.where(iszero, dzero_dr, dpos_dr) * dr_dcr,
          torch.where(iszero, dzero_dl, dpos_dl),
          torch.where(iszero, dzero_dg, dpos_dg))


def _unbroadcast(grad, shape):
  """Reduce a full-shape gradient back to a broadcast input's shape."""
  shape = tuple(shape)
  if tuple(grad.shape) == shape:
    return grad
  extra = grad.ndim - len(shape)
  if extra > 0:
    grad = grad.sum(dim=tuple(range(extra)))
  axes = tuple(i for i, s in enumerate(shape) if s == 1)
  if axes:
    grad = grad.sum(dim=axes, keepdim=True)
  return grad


def _grads_ref(x, count_raw, logits, gate, g, constrained: bool, need):
  """Plain backward: float32 math on widened bf16 operands; a (B, D) field
  is rounded to the write dtype (``_write_dtype``) as the kernel writes
  it, and every gradient comes back in its primal's dtype."""
  params = (count_raw, logits, gate)
  fields = _zinb_grads_elem(x, *(_widen(p) for p in params), constrained)
  bf16_full = _write_dtype(params) == torch.bfloat16
  gb = g.unsqueeze(-1)  # per-row cotangent → per element
  out = []
  for d, p, n in zip(fields, params, need):
    if not n:
      out.append(None)
      continue
    grad = _unbroadcast(gb * d, p.shape)
    if bf16_full and tuple(p.shape) == tuple(x.shape):
      grad = grad.to(torch.bfloat16)
    out.append(grad.to(p.dtype))
  return tuple(out)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------
def _check_operands(x, params):
  """Validate the devices and dtypes the kernels take."""
  dev = x.device
  for t in (x, *params):
    if not t.is_cuda:
      raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
    if t.device != dev:
      raise ValueError(f"operands on {t.device} and {dev}")
    if t.dtype != torch.float32 and (t is x or t.dtype != torch.bfloat16):
      raise TypeError(f"the CUDA kernel takes a float32 x and float32 or "
                      f"bfloat16 parameters, got {t.dtype}")


def _kernel_operands(x, params):
  """The operands as the kernels read them: a bf16 per-gene (…, 1, D) row
  (B > 1) widened to float32, since per-gene rows stay float32."""
  b = x.shape[-2]
  return [_widen(p) if p.dim() >= 2 and p.shape[-2] == 1 < b else p
          for p in params]


def _bf16_mask(params) -> int:
  """Bit i set where operand i (θ operand, logits, gate) is bf16."""
  return sum(1 << i for i, p in enumerate(params)
             if p.dtype == torch.bfloat16)


def _row_strides(x, params):
  """(B, D, row strides) of the operand layouts the kernels read.

  ``x`` is contiguous. A (B, D) parameter needs contiguous rows (unit
  column stride) and is read through its own row stride, so a column
  slice of a wider head output (the 'zinb'/'nb' heads chunk one (B, k·D)
  matrix) is read in place, without a copy; a (1, D) per-gene row gets
  stride 0. Gradients are written contiguous."""
  if not x.is_contiguous():
    raise ValueError("the CUDA kernel takes a contiguous x")
  shape = x.shape
  if len(shape) != 2 or not shape[0] or not shape[1]:
    raise ValueError(f"x must be a non-empty (B, D) matrix, got "
                     f"{tuple(shape)}")
  b, d = shape
  if b >= 2 ** 31 or d >= 2 ** 31:
    raise ValueError(f"shape {tuple(shape)} exceeds the kernel's int32 "
                     "row and column indices")
  lds = []
  for p in params:
    rows, cols = p.shape if p.dim() == 2 else (-1, -1)
    if cols != d or rows not in (b, 1):
      raise ValueError(f"parameter shape {tuple(p.shape)} is neither "
                       f"{(b, d)} nor per-gene {(1, d)}")
    ld, step = p.stride()
    if d > 1 and step != 1:
      raise ValueError("the CUDA kernel takes parameters with contiguous "
                       "rows (unit column stride)")
    if rows == 1:
      lds.append(0 if b > 1 else d)  # per-gene row: stride 0
    elif ld < d:
      raise ValueError(f"parameter rows overlap (row stride {ld} < {d}); "
                       "the kernel reads them in place")
    else:
      lds.append(ld)
  return b, d, lds


def _member_strides(ops, m: int):
  """Member strides in elements of member-batched operands: each has a
  leading axis of ``m``, or of 1 when the members share it (stride 0)."""
  for t in ops:
    if t.dim() != 3 or t.shape[0] not in (1, m):
      raise ValueError(f"member-batched operand of shape {tuple(t.shape)}: "
                       f"expected a leading axis of {m} or 1")
  if m >= 2 ** 16:
    raise ValueError(f"{m} members exceed the launch's grid z (65,535)")
  return [t.stride(0) if t.shape[0] > 1 else 0 for t in ops]


def _ptr(t):
  return None if t is None else t.data_ptr()


def _raise_on(status: int, name: str):
  if status != 0:
    raise RuntimeError(f"{name} launch failed: CUDA error {status}")


class _Plan(NamedTuple):
  """How ``csrc/zinb.cu`` is launched for one call (``_launch_plan``)."""
  vec: bool        # 16-byte cp.async copies; else 4-byte (unaligned rows)
  fwd_tiles: int   # forward: 128-column tiles per chunk of a row
  fwd_chunks: int  # forward: chunks per row, grid (B, fwd_chunks, M)
  bwd_rows: int    # backward: rows each block walks
  bwd_chunks: int  # backward: row chunks, grid (ceil(D / 1024), bwd_chunks, M)


def _launch_plan(b: int, d: int, lds, ptrs, n_sm: int,
                 itemsizes: Optional[Sequence[int]] = None,
                 m: int = 1) -> _Plan:
  """Grid, chunking and copy width of both kernels for ``m`` (b, d)
  problems in one call.

  ``lds`` are the parameters' row strides in elements (``_row_strides``),
  and the member strides of a member-batched call; ``ptrs`` the addresses
  of every operand and output, ``itemsizes`` their bytes per element (4
  each when not given), ``n_sm`` the card's SM count. The wide path copies
  a lane's 4 columns at once: 16 bytes of a float32 row, 8 of a bf16 one.
  So every row start must be aligned to 4 elements: d and each stride a
  multiple of 4, and each pointer a multiple of 4 × its itemsize in
  bytes."""
  sizes = [4] * len(ptrs) if itemsizes is None else list(itemsizes)
  vec = (d % 4 == 0 and not any(p % (4 * n) for p, n in zip(ptrs, sizes))
         and not any(ld % 4 for ld in lds))
  return _Plan(vec, *_grids(b, d, n_sm, m))


@functools.lru_cache(maxsize=4096)
def _grids(b: int, d: int, n_sm: int, m: int = 1):
  """The grids of ``_launch_plan``, aiming at ``_BLOCKS_PER_SM`` blocks per
  SM over the m·b rows of every member: the forward splits rows into column
  chunks only while the rows alone leave the card short; the backward
  splits each member's rows into chunks of at least ``_BWD_MIN_ROWS``
  rows. Both grid y dimensions stay within CUDA's 65,535."""
  target = _BLOCKS_PER_SM * n_sm
  tiles = -(-d // _TILE)
  col_blocks = -(-tiles // _WARPS)
  chunks = min(-(-target // (m * b)), col_blocks, _MAX_GRID_Y)
  per_chunk = _WARPS * -(-(-(-tiles // chunks)) // _WARPS)
  rows = max(_BWD_MIN_ROWS, -(-b // max(1, target // (col_blocks * m))),
             -(-b // _MAX_GRID_Y))
  return per_chunk, -(-tiles // per_chunk), rows, -(-b // rows)


def _scratch(shape, dev, dtype=torch.float32):
  """An uninitialised output or scratch buffer on ``dev``."""
  return torch.empty(shape, device=dev, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
  return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(dev, name: str, fn, *args):
  """Call a C entry point on ``dev`` and PyTorch's current stream there."""
  with torch.cuda.device(dev):
    _raise_on(fn(*args, torch.cuda.current_stream(dev).cuda_stream), name)


def _layout(x, params, members: int):
  """(B, D, row strides, member strides) of a call. A (B, D) call
  (``members`` = 0) reads its tensors as they are, without a view (the
  host time of a launch matters: a step is host-bound); its member
  strides are 0."""
  if not members:
    return (*_row_strides(x, params), [0] * (1 + len(params)))
  b, d, lds = _row_strides(x[0], [p[0] for p in params])
  return b, d, lds, _member_strides((x, *params), members)


def _fwd_launch(x, count_raw, logits, gate, constrained: bool,
                members: int = 0):
  """The forward kernel. ``members`` = 0: one (B, D) problem → (B,).
  ``members`` = M: every operand has a leading member axis, of M or of 1
  for an operand the members share (read through a member stride of 0),
  → (M, B), in one launch."""
  from . import _build
  params = (count_raw, logits, gate)
  _check_operands(x, params)
  m = max(1, members)
  params = _kernel_operands(x, params)
  b, d, lds, mss = _layout(x, params, members)
  mask = _bf16_mask(params)
  ptrs = [t.data_ptr() for t in (x, *params)]
  plan = _launch_plan(b, d, lds + mss, ptrs, _sm_count(x.device),
                      [t.element_size() for t in (x, *params)], m)
  lib = _build.load()
  out = _scratch((m, b) if members else (b,), x.device)
  partial = (None if plan.fwd_chunks == 1 else
             _scratch((m * b, plan.fwd_chunks), x.device))
  args = (*ptrs, out.data_ptr(), _ptr(partial), m, b, d, *mss, *lds,
          int(plan.vec), plan.fwd_tiles, plan.fwd_chunks, int(constrained))
  if mask:
    _launch(x.device, "zinb_rowsum_fwd", lib.sisua_zinb_rowsum_fwd_bf16,
            *args, mask)
  else:
    _launch(x.device, "zinb_rowsum_fwd", lib.sisua_zinb_rowsum_fwd, *args)
  launches["zinb_rowsum_fwd"] += 1
  return out


def _bwd_launch(x, count_raw, logits, gate, g, constrained: bool, need,
                members: int = 0):
  """The three gradient fields, each in its primal's dtype (None where
  not needed). A (B, D) field is written in ``_write_dtype``; with bf16
  writes for a float32 primal it is widened afterwards. ``members`` as in
  ``_fwd_launch``: then ``g`` is (M, B) and every field has the member
  axis, (M, B, D) or per-gene (M, 1, D), shared operands included."""
  from . import _build
  primals = (count_raw, logits, gate)
  _check_operands(x, primals)
  m = max(1, members)
  params = _kernel_operands(x, primals)
  b, d, lds, mss = _layout(x, params, members)
  mask = _bf16_mask(params)
  g = g.contiguous()
  if g.dtype != torch.float32 or g.numel() != m * b \
      or g.shape[-1:] != (b,):
    raise ValueError(f"cotangent must be float32 with {m} × {b} rows, got "
                     f"{g.dtype} {tuple(g.shape)}")
  full = _write_dtype(primals)

  lead = (m,) if members else ()

  def field(ld):  # per-gene fields are f32 sums
    if ld and full == torch.bfloat16:
      return _scratch((*lead, b, d), x.device, torch.bfloat16)
    return _scratch((*lead, b, d) if ld else (*lead, 1, d), x.device)
  outs = [field(ld) if n else None for ld, n in zip(lds, need)]
  ptrs = [t.data_ptr() for t in (x, *params)]
  out_ptrs = [_ptr(o) for o in outs]
  plan = _launch_plan(
      b, d, lds + mss, ptrs + [p for p in out_ptrs if p],
      _sm_count(x.device),
      [t.element_size() for t in (x, *params)]
      + [o.element_size() for o in outs if o is not None], m)
  lib = _build.load()
  partial = None
  if any(n and ld == 0 for ld, n in zip(lds, need)):
    partial = _scratch((*lead, 3, plan.bwd_chunks, d), x.device)
  args = (*ptrs, g.data_ptr(), *out_ptrs, _ptr(partial), m, b, d, *mss,
          *lds, int(plan.vec), plan.bwd_rows, plan.bwd_chunks,
          int(constrained))
  if mask or full == torch.bfloat16:
    _launch(x.device, "zinb_rowsum_bwd", lib.sisua_zinb_rowsum_bwd_bf16,
            *args, mask, int(full == torch.bfloat16))
  else:
    _launch(x.device, "zinb_rowsum_bwd", lib.sisua_zinb_rowsum_bwd, *args)
  launches["zinb_rowsum_bwd"] += 1
  return tuple(None if o is None else o.to(p.dtype)
               for o, p in zip(outs, primals))


def _launches_kernel(x: torch.Tensor) -> bool:
  """The dispatch rule: every tensor that is not on the CPU goes to the
  kernels, which take CUDA tensors or raise."""
  return x.device.type != "cpu"


def _vmapped(m: int, in_dims, tensors):
  """``torch.func.vmap``'s operands with the member axis first, or a
  leading axis of 1 where an operand is not batched (the members share
  it). Rows keep a unit column stride, as the kernels read them."""
  out = []
  for t, d in zip(tensors, in_dims):
    t = t.unsqueeze(0) if d is None else t.movedim(d, 0)
    out.append(t.contiguous() if t.stride(-1) != 1 else t)
  x = out[0]
  if not x[0].is_contiguous():
    out[0] = x.contiguous()
  return out


class _ZinbRowsumBwd(torch.autograd.Function):
  """The backward of ``_ZinbRowsum`` as an operator of its own, so that
  ``torch.func.vmap(torch.func.grad(…))`` batches it through ``vmap``
  below: one member-batched launch for all members."""

  @staticmethod
  def forward(x, count_raw, logits, gate, g, constrained, need):
    if _launches_kernel(x):
      return _bwd_launch(x, count_raw, logits, gate, g, constrained, need)
    return _grads_ref(x, count_raw, logits, gate, g, constrained, need)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def backward(ctx, *grads):
    raise NotImplementedError("the fused ZINB row sum has no second "
                              "derivative")

  @staticmethod
  def vmap(info, in_dims, x, count_raw, logits, gate, g, constrained,
           need):
    m = info.batch_size
    x, cr, lg, gt, g = _vmapped(m, in_dims[:5], (x, count_raw, logits, gate,
                                                 g))
    if _launches_kernel(x):
      grads = _bwd_launch(x, cr, lg, gt, g.expand(m, -1), constrained,
                          need, members=m)
    else:  # every field per member, shared primals included
      grads = _grads_ref(*(t.expand(m, *t.shape[1:])
                           for t in (x, cr, lg, gt, g)), constrained, need)
    return grads, tuple(None if gr is None else 0 for gr in grads)


class _ZinbRowsum(torch.autograd.Function):
  """Row-summed ZINB log-pmf with the analytic backward (the JAX
  ``_zinb_rowsum`` custom VJP). CPU tensors: plain versions; CUDA tensors:
  the two kernels. Under ``torch.func.vmap`` the members go onto one
  launch of each kernel (``vmap``), as Pallas's batching rule puts them on
  the TPU kernel's grid."""

  @staticmethod
  def forward(x, count_raw, logits, gate, constrained):
    if _launches_kernel(x):
      return _fwd_launch(x, count_raw, logits, gate, constrained)
    return _rowsum_ref(x, count_raw, logits, gate, constrained)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, count_raw, logits, gate, constrained = inputs
    ctx.constrained = bool(constrained)
    ctx.save_for_backward(x, count_raw, logits, gate)

  @staticmethod
  def backward(ctx, g):
    x, count_raw, logits, gate = ctx.saved_tensors
    need = tuple(ctx.needs_input_grad[1:4])
    grads = _ZinbRowsumBwd.apply(x, count_raw, logits, gate, g,
                                 ctx.constrained, need)
    return (None, *grads, None)

  @staticmethod
  def vmap(info, in_dims, x, count_raw, logits, gate, constrained):
    m = info.batch_size
    ops = _vmapped(m, in_dims[:4], (x, count_raw, logits, gate))
    if _launches_kernel(ops[0]):
      return _fwd_launch(*ops, bool(constrained), members=m), 0
    out = _rowsum_ref(*ops, bool(constrained))
    return out.expand(m, *out.shape[1:]), 0


def _norm_param(p, x):
  """(D,) → (1, D) and scalar → a (1, D) row next to a 2-D ``x``, so the
  kernels see the per-gene layout; other shapes pass through."""
  if not isinstance(p, torch.Tensor):
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
  if x.ndim == 2:
    if p.ndim == 1 and p.shape[0] == x.shape[1]:
      return p[None]
    if p.ndim == 0:
      return p.reshape(1, 1).expand(1, x.shape[1]).contiguous()
  return p


def zinb_log_prob_rowsum(x, count_raw, logits, gate_logits,
                         constrained: bool = False):
  """Per-row Σ_genes ZINB log-pmf. Parameters may be (B, D), per-gene
  (D,)/(1, D) or scalar; ``constrained=False`` reads ``count_raw`` as
  log θ (θ = exp(clip(·, ±15))), ``True`` as θ (floored at 1e-8)."""
  return _ZinbRowsum.apply(x, _norm_param(count_raw, x),
                           _norm_param(logits, x),
                           _norm_param(gate_logits, x), constrained)


def nb_log_prob_rowsum(x, count_raw, logits, constrained: bool = False):
  """Gate-free NB: the ZINB kernel with a constant per-gene −1e30 gate row
  (one (1, D) row, and no gate gradient is ever written)."""
  gate = (torch.full((1, x.shape[-1]), _NB_GATE, dtype=x.dtype,
                     device=x.device) if x.ndim == 2
          else torch.full_like(logits, _NB_GATE))
  return _ZinbRowsum.apply(x, _norm_param(count_raw, x),
                           _norm_param(logits, x), gate, constrained)


def _disp_to_logits(mu, theta, eps: float = 1e-8):
  """NB(μ, θ) is exactly NB(total_count=θ, logits=log μ − log θ)."""
  return torch.log(mu + eps) - torch.log(theta + eps)


def zinbd_log_prob_rowsum(x, mu, theta, gate_logits):
  """ZINB in scVI's mean/dispersion parameterization."""
  return zinb_log_prob_rowsum(x, theta, _disp_to_logits(mu, theta),
                              gate_logits, constrained=True)


def nbd_log_prob_rowsum(x, mu, theta):
  """NB mean/dispersion variant ('nbd')."""
  return nb_log_prob_rowsum(x, theta, _disp_to_logits(mu, theta), True)

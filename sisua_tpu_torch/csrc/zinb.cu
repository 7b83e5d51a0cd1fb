// Fused ZINB/NB log-likelihood row reduction and its analytic backward,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sisua_tpu/ops/zinb_pallas.py:
//   zinb_rowsum_fwd  <- _make_kernel (inner `kernel`, zinb_pallas.py:172)
//   zinb_rowsum_bwd  <- _make_bwd_kernel (inner `kernel`, zinb_pallas.py:339)
// Each computes what the TPU kernel computes, element for element
// (_zinb_elem and _zinb_grads_elem there, and the plain PyTorch versions
// in sisua_tpu_torch/ops/zinb.py), not the TPU's grid.
//
// What bounds them on the card (NVIDIA H100 80GB HBM3 at 700 W, 512 x
// 33,000, ~7% nonzero counts; tools/zinb_kernel_ab.py). The bytes bound is
// 81 us forward (4 f32 reads per element) and 141 us backward (4 reads and
// up to 3 writes). A kernel with one element per thread and a branch on
// x <= 0 is bound by instruction issue instead: ~90% of warps of 32 genes
// hold a nonzero and run both paths, and CUDA's general-range log1pf
// (FFMA polynomial code, no MUFU) was most of the zero path. The design:
//   * Count path compacted per warp. Every lane does the zero path's work
//     for its 4 elements; the nonzero elements are queued in lane order
//     (__ballot_sync/__popc) and the lgammaf / digamma work runs on full
//     warps of queued elements only. The forward carries the queue across
//     tiles (up to 31 elements wait in registers), so its count path costs
//     what the nonzero share needs: 7% nonzero runs as fast as none. The
//     backward runs each tile's queue and returns the results to their
//     elements through shared memory, so its stores stay coalesced.
//     The queue order is fixed by the data: results are reproducible.
//   * Fewer, cheaper transcendentals: one exp(-|v|) and one log1p per logit
//     and per gate give log-sigmoid and softplus of both signs; one
//     reciprocal gives sigmoid of both signs; log1p on [0, 1] is a short
//     atanh series (log1p_unit); exp is __expf; the backward's posterior
//     weight exp(b - logaddexp(a, b)) is the sigmoid it equals.
//   * Tiles streamed with cp.async into a two-stage ring in shared memory,
//     one ring per warp: 16-byte copies where every row pointer and row
//     stride is 16-byte aligned (the launch plan in ops/zinb.py decides),
//     4-byte copies otherwise (the SISUA protein head: D = 10, column
//     offsets of 40 and 80 bytes; ragged widths). A lane copies and first
//     reads its own 4 columns, so the ring needs only warp barriers.
//   * Work spread over the card: the forward splits each row into column
//     chunks (grid rows x chunks) while the batch alone leaves SMs idle and
//     sums the chunk partials per row in a second pass, in order; the
//     backward tiles (rows x 1024 columns) and keeps per-gene (1, D)
//     gradients as ordered chunk sums. No float atomics anywhere: two runs
//     give the same bits.
// Measured after the redesign: ~115 us forward and ~190 us backward
// (70-75% of the bytes bounds, at 0%, 0.5% and 7% nonzero alike), where the
// one-element-per-thread kernels took ~240 and ~295 us. The SASS holds ~97
// (forward) and ~127 (backward) instructions per element from a tile's
// arrival to its first ballot: ~49 and ~65 us at the card's full issue
// rate, under the bytes bounds. Both kernels are now bound by bytes, at
// ~2.5 TB/s of HBM's 3.35.
//
// A per-gene (1, D) operand is a row stride of 0. Ragged edges are masked
// here, so any B and D are taken (the TPU path needed B % 8 == 0).
//
// The member axis (jax.vmap of the TPU kernels: Pallas's batching rule adds
// a grid axis over the vmapped members). M problems of the same (B, D) run
// in one launch as grid z; each operand has a member stride in elements, 0
// for an operand the members share (the shared counts of an ensemble, read
// once from HBM and then mostly from L2). Outputs are member-major: out
// (M, B), (B, D) fields (M, B, D), per-gene fields (M, 1, D), each member's
// per-gene partials its own (3, chunks, D) slab summed by column_sum_kernel
// with grid y over members. With M = 1 every member offset is 0, so the
// addresses, the plan and the bits are those of the launch without the axis.
//
// The bf16 modes of the TPU kernels (zinb_pallas.py, SISUA_TPU_FWD_OPERANDS
// and _bwd_write_dtype), in the MIXED instantiations that the *_bf16 entry
// points launch (the float32 entry points keep MIXED = false, so their code
// is the float32 kernels' own):
//   * bf16 operands: any (B, D) theta operand, logits or gate may be bf16
//     (a bit each in `bf16_ops`); x and per-gene rows stay float32. A bf16
//     operand fills 8 elements per 16 bytes, so its tile takes half of the
//     operand's 512-byte slot of the ring: a lane copies its 4 columns as
//     one 8-byte cp.async (rows 8-byte aligned), or with ordinary 2-byte
//     loads where a row is not (cp.async has no 2-byte copy; the 10-protein
//     head's rows start 20 bytes apart). Loads widen to f32 in registers
//     (the bf16 bits in the high half of a float, as __bfloat162float); all
//     arithmetic is the float32 kernels', element for element.
//   * bf16 gradient writes (`bf16_out`): each (B, D) field is rounded to
//     nearest even (__float2bfloat16_rn, as Tensor.to(torch.bfloat16)) and
//     written as bf16: 2 bytes an element instead of 4. Per-gene (1, D)
//     gradients are still ordered f32 chunk sums written as f32.
// Bounds at 512 x 33,000 with bf16 (B, D) operands and writes: forward 10
// bytes an element (50.4 us), backward 16 (80.7 us); f32 operands with bf16
// writes: backward 22 (111.0 us).
//
// Numerics kept from the TPU kernel: the large-theta asymptotic branch above
// theta = 1e6, the cancellation-free digamma difference, the constrained
// theta handling, and stable log-sigmoid/softplus/logaddexp forms where exp
// never sees a positive argument, so the -1e30 "no inflation" gate of the
// NB heads stays exact. lgammaf comes from CUDA's device math library
// (Mosaic had none, hence Stirling on the TPU). Clamps are written so a NaN
// operand stays NaN (fmaxf/fminf would drop it and hide a diverged step
// from the trainer's NaN check). FMA contraction is on: with it and without
// it every case passes the same tolerances (see ops/_build.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with probe.cu into one library (see
//        ops/_build.py). The tile loader lives in tile_ring.cuh.
// Each entry point launches on the given stream, does not synchronize and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr float kExpClip = 15.0f;
constexpr float kThetaFloor = 1e-8f;
constexpr float kAsymTheta = 1e6f;

// A warp's count-path queue. Backward: the tile's nonzero elements (their
// index in the tile) and the results by element. Forward: the (x, theta)
// of nonzero elements waiting for a full warp.
union CountQueue {
  struct {
    float res[kTile];
    unsigned char elem[kTile];
  } bwd;
  struct {
    float x[kTile];
    float r[kTile];
  } fwd;
};

// One warp's shared memory: the ring of operand tiles (x, theta operand,
// logits, gate) and the count-path queue.
struct alignas(16) WarpSmem {
  float stage[kStages][4][kTile];
  CountQueue q;
};

// One staged value of one operand, widened to float32
__device__ __forceinline__ float stage_val(const float* slot, bool bf16,
                                           int e) {
  return bf16 ? bf16_bits_to_float(
                    reinterpret_cast<const unsigned short*>(slot)[e])
              : slot[e];
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);  // NaN passes through
}

// exp is __expf (ex2.approx): relative error ~1e-6 over the arguments met
// here (theta's clip at +-15, exp(-|v|) <= 1), far inside the kernels'
// tolerances: a multiply and one MUFU.EX2, without expf's range reduction.
template <bool CONSTRAINED>
__device__ __forceinline__ float theta_of(float cr) {
  return CONSTRAINED ? (cr < kThetaFloor ? kThetaFloor : cr)
                     : __expf(clip(cr, -kExpClip, kExpClip));
}

// log1p(e) for e in [0, 1], the range of exp(-|v|): 2 atanh(s) with
// s = e / (2 + e) in [0, 1/3], summed to s^15 (the rest is below 2e-9
// relative). A dozen instructions and within a few ulp of log1pf, whose
// general-range polynomial code was most of the zero path's issue slots
// in the SASS. NaN stays NaN.
__device__ __forceinline__ float log1p_unit(float e) {
  const float s = __fdividef(e, 2.0f + e);  // 2 + e in [2, 3]
  const float t = s * s;
  float p = 1.0f / 15.0f;
  p = fmaf(p, t, 1.0f / 13.0f);
  p = fmaf(p, t, 1.0f / 11.0f);
  p = fmaf(p, t, 1.0f / 9.0f);
  p = fmaf(p, t, 1.0f / 7.0f);
  p = fmaf(p, t, 1.0f / 5.0f);
  p = fmaf(p, t, 1.0f / 3.0f);
  const float s2 = s + s;
  return fmaf(s2 * t, p, s2);
}

// The terms every function of a logit v needs: e = exp(-|v|) (exp never
// sees a positive argument) and L = log1p(e). Then
//   log sigmoid(+-v) = min(+-v, 0) - L,  softplus(v) = max(v, 0) + L.
struct LogitTerms {
  float v, e, L;
  __device__ __forceinline__ float log_sig() const {
    return fminf(v, 0.0f) - L;
  }
  __device__ __forceinline__ float log_sig_neg() const {
    return fminf(-v, 0.0f) - L;
  }
  __device__ __forceinline__ float softplus() const {
    return fmaxf(v, 0.0f) + L;
  }
};

__device__ __forceinline__ LogitTerms logit_terms(float v) {
  const float e = __expf(-fabsf(v));
  return {v, e, log1p_unit(e)};
}

// sigmoid(v) and sigmoid(-v) from e = exp(-|v|) and one reciprocal
struct Sigmoids {
  float pos, neg;
};

__device__ __forceinline__ Sigmoids sigmoids(float v, float e) {
  const float inv = 1.0f / (1.0f + e);
  return {v >= 0.0f ? inv : e * inv, v <= 0.0f ? inv : e * inv};
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1p_unit(__expf(-fabsf(a - b)));
}

// The count path of the forward: log-pmf terms that need lgamma,
// lgamma(x + r) - lgamma(r) - lgamma(x + 1), with the TPU kernel's
// asymptotic form above theta = 1e6 (pure cancellation there otherwise).
__device__ __forceinline__ float count_term_fwd(float x, float r) {
  const float lg_diff = r > kAsymTheta
      ? x * logf(r) + x * (x - 1.0f) / (2.0f * r)
      : lgammaf(x + r) - lgammaf(r);
  return lg_diff - lgammaf(x + 1.0f);
}

// psi(x + r) - psi(r) without cancellation, r > 0, x >= 0
// (zinb_pallas.py _digamma_diff): every term is proportional to x.
__device__ __forceinline__ float digamma_diff(float r, float x) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float fk = static_cast<float>(k);
    s += x / ((r + fk) * (x + r + fk));
  }
  const float y1 = r + 6.0f;
  const float inv1 = 1.0f / y1;
  const float inv2 = 1.0f / (x + y1);
  const float di = -x * inv1 * inv2;
  const float si = inv1 + inv2;
  const float i1s = inv1 * inv1;
  const float i2s = inv2 * inv2;
  const float out = log1pf(x * inv1) - 0.5f * di
      - di * si * (1.0f / 12.0f - (1.0f / 120.0f) * (i1s + i2s)
                   + (1.0f / 252.0f) * (i1s * i1s + i1s * i2s + i2s * i2s));
  return out + s;
}

// The count path of the backward: d lgamma(x + r) / dr - d lgamma(r) / dr,
// with the forward's large-theta switch mirrored.
__device__ __forceinline__ float count_term_bwd(float x, float r) {
  return r > kAsymTheta ? x / r - x * (x - 1.0f) / (2.0f * r * r)
                        : digamma_diff(r, x);
}

// Queue the warp's nonzero elements of this tile in lane order (for each
// k, lanes 0..31): put(j, k) stores this lane's element k at queue
// position j. Returns their count, the same in every lane.
template <class Put>
__device__ __forceinline__ int enqueue(const bool (&nz)[kVec], int lane,
                                       Put put) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const unsigned m = __ballot_sync(0xffffffffu, nz[k]);
    if (nz[k]) put(n + __popc(m & below), k);
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// Backward count path on full warps of the tile's queued elements: the
// element at queue position j goes to lane j % 32; its (x, theta) come from
// the stage and its result lands in res[element].
template <bool CONSTRAINED>
__device__ __forceinline__ void run_count_path_bwd(const float (*st)[kTile],
                                                   WarpSmem& w, int n,
                                                   int lane, bool bf16_cr) {
  for (int j = lane; j - lane < n; j += 32) {  // warp-uniform trip count
    if (j < n) {
      const int e = w.q.bwd.elem[j];
      w.q.bwd.res[e] = count_term_bwd(
          st[0][e], theta_of<CONSTRAINED>(stage_val(st[1], bf16_cr, e)));
    }
  }
  __syncwarp();
}

// Forward. Block (row, chunk, member): its 8 warps take the chunk's 128-column
// tiles in turn (warp w: tiles w, w + 8, ...), each through its own ring.
// The block's sum goes to out[row] when a row is one chunk, else to
// partial[row, chunk] for row_chunk_sum_kernel. MIXED: bf16 (B, D)
// operands as `bf16_ops` says.
template <bool CONSTRAINED, bool VEC, bool MIXED>
__global__ void __launch_bounds__(kThreads)
zinb_rowsum_fwd_kernel(const float* __restrict__ x,
                       const void* __restrict__ cr,
                       const void* __restrict__ lg,
                       const void* __restrict__ gt,
                       float* __restrict__ out, float* __restrict__ partial,
                       int D, int64_t ld_cr, int64_t ld_lg, int64_t ld_gt,
                       int64_t ms_x, int64_t ms_cr, int64_t ms_lg,
                       int64_t ms_gt, int tiles_per_chunk, unsigned bf16_ops) {
  __shared__ WarpSmem smem[kWarps];
  __shared__ float warp_sums[kWarps];
  const unsigned bf = MIXED ? bf16_ops : 0u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpSmem& w = smem[warp];
  const int64_t member = blockIdx.z;
  const int64_t row = blockIdx.x;
  const int64_t out_row = member * gridDim.x + row;  // row of out, partial
  const void* const src[4] = {
      x + member * ms_x + row * D,
      row_ptr(row_ptr(cr, member, ms_cr, is_bf16(bf, 1)), row, ld_cr,
              is_bf16(bf, 1)),
      row_ptr(row_ptr(lg, member, ms_lg, is_bf16(bf, 2)), row, ld_lg,
              is_bf16(bf, 2)),
      row_ptr(row_ptr(gt, member, ms_gt, is_bf16(bf, 3)), row, ld_gt,
              is_bf16(bf, 3))};
  const int tiles = static_cast<int>((D + int64_t{kTile} - 1) / kTile);
  const int t0 = blockIdx.y * tiles_per_chunk + warp;
  const int t1 = min(tiles, static_cast<int>(blockIdx.y + 1) * tiles_per_chunk);
  float acc = 0.0f;
  int pending = 0;        // the warp's queued elements not yet run, < 32
  float px = 0.0f, pr = 0.0f;  // lane j < pending holds pending element j
  // the ring: tile i of this warp (t0 + i * kWarps) goes to stage
  // i % kStages, kStages - 1 tiles ahead of the one computed
  auto issue = [&](int stage, int t) {
    if (t < t1) {
      issue_tile<VEC>(w.stage[stage], src,
                      static_cast<int64_t>(t) * kTile + lane * kVec, D, lane,
                      bf);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, t0 + i * kWarps);
  int s = 0;
  for (int t = t0; t < t1; t += kWarps, s = s + 1 == kStages ? 0 : s + 1) {
    issue(s == 0 ? kStages - 1 : s - 1, t + (kStages - 1) * kWarps);
    cp_async_wait_ring();
    __syncwarp();
    const float (*st)[kTile] = w.stage[s];
    const int64_t c = static_cast<int64_t>(t) * kTile + lane * kVec;
    const float4 xv = ld4(&st[0][lane * kVec]);
    const float xs[kVec] = {xv.x, xv.y, xv.z, xv.w};
    float cs[kVec], ls[kVec], gs[kVec];
    stage_vals(st[1], is_bf16(bf, 1), lane * kVec, cs);
    stage_vals(st[2], is_bf16(bf, 2), lane * kVec, ls);
    stage_vals(st[3], is_bf16(bf, 3), lane * kVec, gs);
    bool nz[kVec];
    float rs[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool valid = c + k < D;
      rs[k] = theta_of<CONSTRAINED>(cs[k]);
      const LogitTerms tl = logit_terms(ls[k]), tg = logit_terms(gs[k]);
      const float nb0 = rs[k] * tl.log_sig_neg();
      const float log_1mpi = tg.log_sig_neg();
      nz[k] = valid && !(xs[k] <= 0.0f);  // a NaN count takes the count path
      if (nz[k]) {  // all but the lgamma terms, which the queue adds
        acc += log_1mpi + (nb0 + xs[k] * tl.log_sig());
      } else if (valid) {
        acc += logaddexp(tg.log_sig(), log_1mpi + nb0);
      }
    }
    // queue this tile's nonzero elements after the pending ones, run every
    // full warp of them, keep the rest (< 32) pending in registers
    const int total = pending + enqueue(nz, lane, [&](int j, int k) {
      w.q.fwd.x[j] = xs[k];
      w.q.fwd.r[j] = rs[k];
    });
    for (int v = lane; v - lane + 32 <= total; v += 32) {
      const bool mine = v < pending;  // round 0 only: pending < 32
      acc += count_term_fwd(mine ? px : w.q.fwd.x[v - pending],
                            mine ? pr : w.q.fwd.r[v - pending]);
    }
    const int v = (total & ~31) + lane;
    if (lane < (total & 31) && v >= pending) {
      px = w.q.fwd.x[v - pending];
      pr = w.q.fwd.r[v - pending];
    }
    pending = total & 31;
    __syncwarp();  // every lane is done with stage s and the queue
  }
  if (lane < pending) acc += count_term_fwd(px, pr);
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
    if (lane == 0) {
      if (gridDim.y == 1) {
        out[out_row] = acc;
      } else {
        partial[out_row * gridDim.y + blockIdx.y] = acc;
      }
    }
  }
}

// Store a lane's kVec gradients of one field at row offset `base`, with
// streaming (evict-first) stores: a (B, D) field is written once and is
// larger than L2.
template <bool VEC>
__device__ __forceinline__ void store_field(float* __restrict__ f,
                                            int64_t base, int64_t c,
                                            int64_t D,
                                            const float (&v)[kVec]) {
  if (VEC) {
    if (c < D) {
      __stcs(reinterpret_cast<float4*>(f + base + c),
             make_float4(v[0], v[1], v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (c + k < D) __stcs(f + base + c + k, v[k]);
    }
  }
}

// The bf16 bits of v, rounded to nearest even
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// store_field for a bf16 (B, D) field: 8-byte streaming stores of a lane's
// 4 rounded gradients (rows 8-byte aligned), else 2-byte ones
template <bool VEC>
__device__ __forceinline__ void store_field_bf16(
    unsigned short* __restrict__ f, int64_t base, int64_t c, int64_t D,
    const float (&v)[kVec]) {
  if (VEC) {
    if (c < D) {
      uint2 u;
      u.x = bf16_bits(v[0]) | (static_cast<unsigned>(bf16_bits(v[1])) << 16);
      u.y = bf16_bits(v[2]) | (static_cast<unsigned>(bf16_bits(v[3])) << 16);
      __stcs(reinterpret_cast<uint2*>(f + base + c), u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (c + k < D) __stcs(f + base + c + k, bf16_bits(v[k]));
    }
  }
}

// One (B, D) gradient field's row: float32, or bf16 under `bf16_out`
template <bool VEC>
__device__ __forceinline__ void store_row(void* f, bool bf16_out,
                                          int64_t base, int64_t c,
                                          int64_t D,
                                          const float (&v)[kVec]) {
  if (bf16_out) {
    store_field_bf16<VEC>(static_cast<unsigned short*>(f), base, c, D, v);
  } else {
    store_field<VEC>(static_cast<float*>(f), base, c, D, v);
  }
}

// Backward. Block (column block, row chunk, member): warp w owns the 128-column
// tile 8 * blockIdx.x + w and walks the chunk's rows in order through its
// ring. Full (B, D) fields are written per row; a per-gene (1, D) field is
// summed over the chunk's rows in registers and written to
// partial[field, chunk, column] for column_sum_kernel. MIXED: bf16 (B, D)
// operands as `bf16_ops` says, and bf16 (B, D) fields under `bf16_out`.
template <bool CONSTRAINED, bool VEC, bool MIXED>
__global__ void __launch_bounds__(kThreads)
zinb_rowsum_bwd_kernel(const float* __restrict__ x,
                       const void* __restrict__ cr,
                       const void* __restrict__ lg,
                       const void* __restrict__ gt,
                       const float* __restrict__ gcot,
                       void* __restrict__ d_cr, void* __restrict__ d_lg,
                       void* __restrict__ d_gt,
                       float* __restrict__ partial, int B, int D,
                       int64_t ld_cr, int64_t ld_lg, int64_t ld_gt,
                       int64_t ms_x, int64_t ms_cr, int64_t ms_lg,
                       int64_t ms_gt, int rows_per_chunk, unsigned bf16_ops,
                       int bf16_out) {
  __shared__ WarpSmem smem[kWarps];
  const unsigned bf = MIXED ? bf16_ops : 0u;
  const bool bout = MIXED && bf16_out;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpSmem& w = smem[warp];
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kTile
      + lane * kVec;
  if (c - lane * kVec >= D) return;  // the whole warp is past the last tile
  const int row0 = blockIdx.y * rows_per_chunk;
  const int row1 = min(B, row0 + rows_per_chunk);
  const int64_t member = blockIdx.z;
  const int64_t lds[4] = {D, ld_cr, ld_lg, ld_gt};
  const void* const base[4] = {
      x + member * ms_x, row_ptr(cr, member, ms_cr, is_bf16(bf, 1)),
      row_ptr(lg, member, ms_lg, is_bf16(bf, 2)),
      row_ptr(gt, member, ms_gt, is_bf16(bf, 3))};
  const float* const gm = gcot + member * B;
  // the ring: row row0 + i goes to stage i % kStages, kStages - 1 rows
  // ahead of the one computed
  auto issue_row = [&](int stage, int row) {
    if (row >= row1) {
      cp_async_commit();  // an empty group keeps the count
      return;
    }
    const void* src[4];
#pragma unroll
    for (int op = 0; op < 4; ++op) {
      src[op] = row_ptr(base[op], row, lds[op], is_bf16(bf, op));
    }
    issue_tile<VEC>(w.stage[stage], src, c, D, lane, bf);
  };
  float acc_cr[kVec] = {}, acc_lg[kVec] = {}, acc_gt[kVec] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_row(i, row0 + i);
  int s = 0;
  for (int row = row0; row < row1; ++row, s = s + 1 == kStages ? 0 : s + 1) {
    issue_row(s == 0 ? kStages - 1 : s - 1, row + kStages - 1);
    cp_async_wait_ring();
    __syncwarp();
    const float (*st)[kTile] = w.stage[s];
    const float4 xv = ld4(&st[0][lane * kVec]);
    const float xs[kVec] = {xv.x, xv.y, xv.z, xv.w};
    float cs[kVec], ls[kVec], gs[kVec];
    stage_vals(st[1], is_bf16(bf, 1), lane * kVec, cs);
    stage_vals(st[2], is_bf16(bf, 2), lane * kVec, ls);
    stage_vals(st[3], is_bf16(bf, 3), lane * kVec, gs);
    bool nz[kVec];
    float dr[kVec], dl[kVec], dg[kVec], dr_dcr[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float cr_k = cs[k];
      const float r = theta_of<CONSTRAINED>(cr_k);
      dr_dcr[k] = CONSTRAINED
          ? (cr_k >= kThetaFloor ? 1.0f : 0.0f)
          : r * ((cr_k > -kExpClip && cr_k < kExpClip) ? 1.0f : 0.0f);
      const LogitTerms tl = logit_terms(ls[k]);
      const Sigmoids sl = sigmoids(ls[k], tl.e);
      const Sigmoids sg = sigmoids(gs[k], __expf(-fabsf(gs[k])));
      const float log_1mp = -tl.softplus();
      nz[k] = c + k < D && !(xs[k] <= 0.0f);  // a NaN count: count path
      if (nz[k]) {  // dr is finished once the count path is back
        dr[k] = log_1mp;
        dl[k] = xs[k] * sl.neg - r * sl.pos;
        dg[k] = -sg.pos;
      } else {
        // lp = logaddexp(a, b), a = log sig(g), b = log sig(-g) + nb0:
        // weight by the posterior of the NB arm, exp(b - logaddexp(a, b))
        // = sigmoid(b - a) = sigmoid(nb0 - g), and of the gate,
        // sigmoid(g - nb0); -1e30 (no gate) gives exactly 1 and 0
        const float t = r * log_1mp - gs[k];
        const Sigmoids w = sigmoids(t, __expf(-fabsf(t)));
        dr[k] = w.pos * log_1mp;
        dl[k] = -w.pos * r * sl.pos;
        dg[k] = w.neg * sg.neg - w.pos * sg.pos;
      }
    }
    const int n = enqueue(nz, lane, [&](int j, int k) {
      w.q.bwd.elem[j] = lane * kVec + k;
    });
    run_count_path_bwd<CONSTRAINED>(st, w, n, lane, is_bf16(bf, 1));
    const float4 rv = ld4(&w.q.bwd.res[lane * kVec]);
    const float rs[kVec] = {rv.x, rv.y, rv.z, rv.w};
    const float gr = gm[row];
    float a[kVec], b[kVec], g[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float drk = nz[k] ? rs[k] + dr[k] : dr[k];
      a[k] = drk * dr_dcr[k] * gr;
      b[k] = dl[k] * gr;
      g[k] = dg[k] * gr;
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
    const int64_t off = (member * B + row) * D;
    if (d_cr != nullptr) {
      if (ld_cr) {
        store_row<VEC>(d_cr, bout, off, c, D, a);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc_cr[k] += a[k];
      }
    }
    if (d_lg != nullptr) {
      if (ld_lg) {
        store_row<VEC>(d_lg, bout, off, c, D, b);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc_lg[k] += b[k];
      }
    }
    if (d_gt != nullptr) {
      if (ld_gt) {
        store_row<VEC>(d_gt, bout, off, c, D, g);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc_gt[k] += g[k];
      }
    }
  }
  // per-gene fields: this chunk's sums, one (chunks, D) slab per field,
  // three slabs per member
  const int64_t field = static_cast<int64_t>(gridDim.y) * D;
  const int64_t p = member * 3 * field + static_cast<int64_t>(blockIdx.y) * D;
  if (d_cr != nullptr && !ld_cr) store_field<false>(partial, p, c, D, acc_cr);
  if (d_lg != nullptr && !ld_lg) {
    store_field<false>(partial, field + p, c, D, acc_lg);
  }
  if (d_gt != nullptr && !ld_gt) {
    store_field<false>(partial, 2 * field + p, c, D, acc_gt);
  }
}

// out[m, j] = sum over chunks c, in order, of partial[m, c, j]; member m
// is blockIdx.y, its slab starts `member_stride` floats after the last
__global__ void __launch_bounds__(kSumThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int n_chunks, int D, int64_t member_stride) {
  const int col = blockIdx.x * kSumThreads + threadIdx.x;
  if (col >= D) return;
  partial += blockIdx.y * member_stride;
  out += static_cast<int64_t>(blockIdx.y) * D;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    s += partial[static_cast<int64_t>(c) * D + col];
  }
  out[col] = s;
}

// Both kernels' launches, shared by the float32 and the bf16 entry points
// (MIXED = false for the former: the float32 kernels' code as it was)
template <bool MIXED>
int launch_fwd(const float* x, const void* cr, const void* lg,
               const void* gt, float* out, float* partial, int M, int B,
               int D, long long ms_x, long long ms_cr, long long ms_lg,
               long long ms_gt, long long ld_cr, long long ld_lg,
               long long ld_gt, int vec, int tiles_per_chunk, int n_chunks,
               int constrained, unsigned bf16_ops, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(M));
  auto kernel = constrained
      ? (vec ? zinb_rowsum_fwd_kernel<true, true, MIXED>
             : zinb_rowsum_fwd_kernel<true, false, MIXED>)
      : (vec ? zinb_rowsum_fwd_kernel<false, true, MIXED>
             : zinb_rowsum_fwd_kernel<false, false, MIXED>);
  kernel<<<grid, kThreads, 0, s>>>(x, cr, lg, gt, out, partial, D, ld_cr,
                                   ld_lg, ld_gt, ms_x, ms_cr, ms_lg, ms_gt,
                                   tiles_per_chunk, bf16_ops);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const int rows = M * B;  // the members' rows follow each other
  row_chunk_sum_kernel<<<(rows + kSumThreads - 1) / kSumThreads, kSumThreads,
                         0, s>>>(partial, out, rows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <bool MIXED>
int launch_bwd(const float* x, const void* cr, const void* lg,
               const void* gt, const float* gcot, void* d_cr, void* d_lg,
               void* d_gt, float* partial, int M, int B, int D,
               long long ms_x, long long ms_cr, long long ms_lg,
               long long ms_gt, long long ld_cr, long long ld_lg,
               long long ld_gt, int vec, int rows_per_chunk, int n_chunks,
               int constrained, unsigned bf16_ops, int bf16_out,
               cudaStream_t s) {
  const int col_blocks = (D + kWarps * kTile - 1) / (kWarps * kTile);
  const dim3 grid(static_cast<unsigned>(col_blocks),
                  static_cast<unsigned>(n_chunks), static_cast<unsigned>(M));
  auto kernel = constrained
      ? (vec ? zinb_rowsum_bwd_kernel<true, true, MIXED>
             : zinb_rowsum_bwd_kernel<true, false, MIXED>)
      : (vec ? zinb_rowsum_bwd_kernel<false, true, MIXED>
             : zinb_rowsum_bwd_kernel<false, false, MIXED>);
  kernel<<<grid, kThreads, 0, s>>>(x, cr, lg, gt, gcot, d_cr, d_lg, d_gt,
                                   partial, B, D, ld_cr, ld_lg, ld_gt, ms_x,
                                   ms_cr, ms_lg, ms_gt, rows_per_chunk,
                                   bf16_ops, bf16_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t field = static_cast<int64_t>(n_chunks) * D;
  const dim3 sum_grid(static_cast<unsigned>((D + kSumThreads - 1)
                                            / kSumThreads),
                      static_cast<unsigned>(M));
  void* outs[3] = {d_cr, d_lg, d_gt};
  const long long lds[3] = {ld_cr, ld_lg, ld_gt};
  for (int f = 0; f < 3; ++f) {
    if (outs[f] != nullptr && lds[f] == 0) {  // per-gene: always float32
      column_sum_kernel<<<sum_grid, kSumThreads, 0, s>>>(
          partial + f * field, static_cast<float*>(outs[f]), n_chunks, D,
          3 * field);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[m, b] = sum_j zinb_elem(x[m, b, j], cr[m, b, j], lg[m, b, j],
// gt[m, b, j]) for M members. Each member's x is (B, D) row-major; each
// parameter has its own row stride (0: per gene); each operand its member
// stride (0: shared by the members). The launch plan
// (ops/zinb.py::_launch_plan) gives `vec` (16-byte copies), the 128-column
// tiles per chunk and the chunk count; with more than one chunk, `partial`
// holds M * B * n_chunks floats. M = 1 with member strides 0 is one (B, D)
// problem.
int sisua_zinb_rowsum_fwd(const float* x, const float* cr, const float* lg,
                          const float* gt, float* out, float* partial, int M,
                          int B, int D, long long ms_x, long long ms_cr,
                          long long ms_lg, long long ms_gt, long long ld_cr,
                          long long ld_lg, long long ld_gt, int vec,
                          int tiles_per_chunk, int n_chunks, int constrained,
                          void* stream) {
  return launch_fwd<false>(x, cr, lg, gt, out, partial, M, B, D, ms_x, ms_cr,
                           ms_lg, ms_gt, ld_cr, ld_lg, ld_gt, vec,
                           tiles_per_chunk, n_chunks, constrained, 0u,
                           static_cast<cudaStream_t>(stream));
}

// The forward with bf16 (B, D) operands: bit 0, 1, 2 of `bf16_ops` mark the
// theta operand, the logits and the gate as bf16 (their pointers then point
// at bf16 elements, strides still in elements). `vec` needs every bf16 row
// start 8-byte aligned and every float32 one 16-byte aligned.
int sisua_zinb_rowsum_fwd_bf16(const float* x, const void* cr,
                               const void* lg, const void* gt, float* out,
                               float* partial, int M, int B, int D,
                               long long ms_x, long long ms_cr,
                               long long ms_lg, long long ms_gt,
                               long long ld_cr, long long ld_lg,
                               long long ld_gt, int vec, int tiles_per_chunk,
                               int n_chunks, int constrained, int bf16_ops,
                               void* stream) {
  return launch_fwd<true>(x, cr, lg, gt, out, partial, M, B, D, ms_x, ms_cr,
                          ms_lg, ms_gt, ld_cr, ld_lg, ld_gt, vec,
                          tiles_per_chunk, n_chunks, constrained,
                          static_cast<unsigned>(bf16_ops),
                          static_cast<cudaStream_t>(stream));
}

// Gradient fields times the row cotangent gcot (M, B). A null d_* skips
// that field. A field whose operand has row stride 0 is each member's
// (1, D) sum over rows, written (M, 1, D); then `partial` must hold
// M * 3 * n_chunks * D floats, n_chunks = ceil(B / rows_per_chunk) (the
// launch plan gives both). (B, D) fields are written (M, B, D).
int sisua_zinb_rowsum_bwd(const float* x, const float* cr, const float* lg,
                          const float* gt, const float* gcot, float* d_cr,
                          float* d_lg, float* d_gt, float* partial, int M,
                          int B, int D, long long ms_x, long long ms_cr,
                          long long ms_lg, long long ms_gt, long long ld_cr,
                          long long ld_lg, long long ld_gt, int vec,
                          int rows_per_chunk, int n_chunks, int constrained,
                          void* stream) {
  return launch_bwd<false>(x, cr, lg, gt, gcot, d_cr, d_lg, d_gt, partial, M,
                           B, D, ms_x, ms_cr, ms_lg, ms_gt, ld_cr, ld_lg,
                           ld_gt, vec, rows_per_chunk, n_chunks, constrained,
                           0u, 0, static_cast<cudaStream_t>(stream));
}

// The backward with bf16 (B, D) operands (`bf16_ops` as in the forward)
// and/or bf16 (B, D) gradient writes (`bf16_out`: d_* of a (B, D) field
// then point at bf16 elements; per-gene fields stay float32). `vec` needs
// the bf16 outputs' rows 8-byte aligned.
int sisua_zinb_rowsum_bwd_bf16(const float* x, const void* cr,
                               const void* lg, const void* gt,
                               const float* gcot, void* d_cr, void* d_lg,
                               void* d_gt, float* partial, int M, int B,
                               int D, long long ms_x, long long ms_cr,
                               long long ms_lg, long long ms_gt,
                               long long ld_cr, long long ld_lg,
                               long long ld_gt, int vec, int rows_per_chunk,
                               int n_chunks, int constrained, int bf16_ops,
                               int bf16_out, void* stream) {
  return launch_bwd<true>(x, cr, lg, gt, gcot, d_cr, d_lg, d_gt, partial, M,
                          B, D, ms_x, ms_cr, ms_lg, ms_gt, ld_cr, ld_lg,
                          ld_gt, vec, rows_per_chunk, n_chunks, constrained,
                          static_cast<unsigned>(bf16_ops), bf16_out,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"

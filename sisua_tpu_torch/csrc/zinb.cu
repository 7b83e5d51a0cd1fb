// Fused ZINB/NB log-likelihood row reduction and its analytic backward,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sisua_tpu/ops/zinb_pallas.py:
//   zinb_rowsum_fwd  <- _make_kernel (inner `kernel`)
//   zinb_rowsum_bwd  <- _make_bwd_kernel (inner `kernel`)
// Each computes what the TPU kernel computes, element for element
// (_zinb_elem and _zinb_grads_elem there, and the plain PyTorch versions
// in sisua_tpu_torch/ops/zinb.py), not the TPU's grid:
//   * forward: one block per row walks all D columns (coalesced loads,
//     neighbouring threads on neighbouring columns) and reduces the row with
//     warp shuffles and one shared-memory step, in a fixed order;
//   * backward: a block owns a tile of 128 columns and a chunk of rows. Full
//     (B, D) gradient fields are written directly; a per-gene (1, D) field is
//     summed over the block's rows in registers, the chunk sums land in a
//     scratch buffer, and a second pass sums the chunks in order. No float
//     atomics, so two runs give the same bits.
// A per-gene (1, D) operand is a row stride of 0. Ragged edges are masked
// here, so any B and D are taken (the TPU path needed B % 8 == 0).
//
// What bounds them on the card: bytes. Forward reads 4 f32 per element and
// writes 4 bytes per row; backward reads 4 f32 and writes up to 3 f32 per
// element. The element math (lgammaf, log1pf, expf) is a few dozen flops per
// 16-28 bytes, under the H100's flop:byte balance, so the design keeps every
// intermediate in registers and touches each operand once per pass.
//
// Numerics kept from the TPU kernel: the large-theta asymptotic branch above
// theta = 1e6, the cancellation-free digamma difference, the constrained
// theta handling, and stable log-sigmoid/softplus/logaddexp forms, so the
// -1e30 "no inflation" gate of the NB heads stays exact. lgammaf comes from
// CUDA's device math library (Mosaic had none, hence Stirling on the TPU).
// Clamps are written so a NaN operand stays NaN (fmaxf/fminf would drop it
// and hide a diverged step from the trainer's NaN check).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).
// Each entry point launches on the given stream, does not synchronize and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kExpClip = 15.0f;
constexpr float kThetaFloor = 1e-8f;
constexpr float kAsymTheta = 1e6f;
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kSumThreads = 256;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  const float e = expf(-fabsf(x));  // exp never sees a positive argument
  return x >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);  // NaN passes through
}

template <bool CONSTRAINED>
__device__ __forceinline__ float theta_of(float cr) {
  return CONSTRAINED ? (cr < kThetaFloor ? kThetaFloor : cr)
                     : expf(clip(cr, -kExpClip, kExpClip));
}

// ZINB log-pmf of one element (sisua_tpu/ops/zinb_pallas.py _zinb_elem).
template <bool CONSTRAINED>
__device__ __forceinline__ float zinb_elem(float x, float cr, float l,
                                           float g) {
  const float r = theta_of<CONSTRAINED>(cr);
  const float log_1mp = log_sigmoid(-l);
  const float log_1mpi = log_sigmoid(-g);
  if (x <= 0.0f) {
    return logaddexp(log_sigmoid(g), log_1mpi + r * log_1mp);
  }
  const float lg_diff = r > kAsymTheta
      ? x * logf(r) + x * (x - 1.0f) / (2.0f * r)
      : lgammaf(x + r) - lgammaf(r);
  const float nb = lg_diff - lgammaf(x + 1.0f) + r * log_1mp
      + x * log_sigmoid(l);
  return log_1mpi + nb;
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

// d log-pmf / d(count_raw, logits, gate) of one element
// (zinb_pallas.py _zinb_grads_elem).
template <bool CONSTRAINED>
__device__ __forceinline__ void zinb_grads_elem(float x, float cr, float l,
                                                float g, float* d_cr,
                                                float* d_l, float* d_g) {
  float r, dr_dcr;
  if (CONSTRAINED) {
    r = theta_of<true>(cr);
    dr_dcr = cr >= kThetaFloor ? 1.0f : 0.0f;
  } else {
    r = theta_of<false>(cr);
    dr_dcr = r * ((cr > -kExpClip && cr < kExpClip) ? 1.0f : 0.0f);
  }
  const float sig_l = sigmoid(l);
  const float log_1mp = -softplus(l);
  const float sig_g = sigmoid(g);
  float dr, dl, dg;
  if (x <= 0.0f) {
    // lp = logaddexp(log sig(g), log sig(-g) + nb0): weight by the
    // posterior of the NB arm
    const float a = -softplus(-g);
    const float b = -softplus(g) + r * log_1mp;
    const float wb = expf(b - logaddexp(a, b));
    dr = wb * log_1mp;
    dl = -wb * r * sig_l;
    dg = (1.0f - wb) * sigmoid(-g) - wb * sig_g;
  } else {
    const float dig = r > kAsymTheta
        ? x / r - x * (x - 1.0f) / (2.0f * r * r)
        : digamma_diff(r, x);
    dr = dig + log_1mp;
    dl = x * sigmoid(-l) - r * sig_l;
    dg = -sig_g;
  }
  *d_cr = dr * dr_dcr;
  *d_l = dl;
  *d_g = dg;
}

template <bool CONSTRAINED>
__global__ void __launch_bounds__(kFwdThreads)
zinb_rowsum_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ cr,
                       const float* __restrict__ lg,
                       const float* __restrict__ gt,
                       float* __restrict__ out, int D, int64_t ld_cr,
                       int64_t ld_lg, int64_t ld_gt) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * D;
  const float* crr = cr + row * ld_cr;
  const float* lgr = lg + row * ld_lg;
  const float* gtr = gt + row * ld_gt;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < D; j += kFwdThreads) {
    acc += zinb_elem<CONSTRAINED>(xr[j], crr[j], lgr[j], gtr[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ float warp_sums[kFwdThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kFwdThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[row] = acc;
  }
}

template <bool CONSTRAINED>
__global__ void __launch_bounds__(kBwdThreads)
zinb_rowsum_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ cr,
                       const float* __restrict__ lg,
                       const float* __restrict__ gt,
                       const float* __restrict__ gcot,
                       float* __restrict__ d_cr, float* __restrict__ d_lg,
                       float* __restrict__ d_gt,
                       float* __restrict__ partial, int B, int D,
                       int64_t ld_cr, int64_t ld_lg, int64_t ld_gt,
                       int rows_per_block) {
  const int col = blockIdx.x * kBwdThreads + threadIdx.x;
  if (col >= D) return;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(B, row0 + rows_per_block);
  float acc_cr = 0.0f, acc_lg = 0.0f, acc_gt = 0.0f;
  for (int row = row0; row < row1; ++row) {
    const int64_t i = static_cast<int64_t>(row) * D + col;
    float a, b, c;
    zinb_grads_elem<CONSTRAINED>(x[i], cr[row * ld_cr + col],
                                 lg[row * ld_lg + col],
                                 gt[row * ld_gt + col], &a, &b, &c);
    const float gr = gcot[row];
    a *= gr;
    b *= gr;
    c *= gr;
    if (d_cr != nullptr) {
      if (ld_cr) d_cr[i] = a; else acc_cr += a;
    }
    if (d_lg != nullptr) {
      if (ld_lg) d_lg[i] = b; else acc_lg += b;
    }
    if (d_gt != nullptr) {
      if (ld_gt) d_gt[i] = c; else acc_gt += c;
    }
  }
  // per-gene fields: this chunk's sums, one row of the scratch per field
  const int64_t p = static_cast<int64_t>(blockIdx.y) * D + col;
  const int64_t field = static_cast<int64_t>(gridDim.y) * D;
  if (d_cr != nullptr && !ld_cr) partial[p] = acc_cr;
  if (d_lg != nullptr && !ld_lg) partial[field + p] = acc_lg;
  if (d_gt != nullptr && !ld_gt) partial[2 * field + p] = acc_gt;
}

// out[j] = sum over chunks c, in order, of partial[c, j]
__global__ void __launch_bounds__(kSumThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int n_chunks, int D) {
  const int col = blockIdx.x * kSumThreads + threadIdx.x;
  if (col >= D) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    s += partial[static_cast<int64_t>(c) * D + col];
  }
  out[col] = s;
}

}  // namespace

extern "C" {

// out[b] = sum_j zinb_elem(x[b, j], cr[b, j], lg[b, j], gt[b, j]).
// x is (B, D) row-major; each parameter has row stride D or 0 (per gene).
int sisua_zinb_rowsum_fwd(const float* x, const float* cr, const float* lg,
                          const float* gt, float* out, int B, int D,
                          long long ld_cr, long long ld_lg, long long ld_gt,
                          int constrained, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B));
  if (constrained) {
    zinb_rowsum_fwd_kernel<true><<<grid, kFwdThreads, 0, s>>>(
        x, cr, lg, gt, out, D, ld_cr, ld_lg, ld_gt);
  } else {
    zinb_rowsum_fwd_kernel<false><<<grid, kFwdThreads, 0, s>>>(
        x, cr, lg, gt, out, D, ld_cr, ld_lg, ld_gt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Gradient fields times the row cotangent gcot (B,). A null d_* skips that
// field. A field whose operand has row stride 0 is the (1, D) sum over rows;
// then `partial` must hold 3 * ceil(B / rows_per_block) * D floats.
int sisua_zinb_rowsum_bwd(const float* x, const float* cr, const float* lg,
                          const float* gt, const float* gcot, float* d_cr,
                          float* d_lg, float* d_gt, float* partial, int B,
                          int D, long long ld_cr, long long ld_lg,
                          long long ld_gt, int rows_per_block,
                          int constrained, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (B + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>((D + kBwdThreads - 1) / kBwdThreads),
                  static_cast<unsigned>(n_chunks));
  if (constrained) {
    zinb_rowsum_bwd_kernel<true><<<grid, kBwdThreads, 0, s>>>(
        x, cr, lg, gt, gcot, d_cr, d_lg, d_gt, partial, B, D, ld_cr, ld_lg,
        ld_gt, rows_per_block);
  } else {
    zinb_rowsum_bwd_kernel<false><<<grid, kBwdThreads, 0, s>>>(
        x, cr, lg, gt, gcot, d_cr, d_lg, d_gt, partial, B, D, ld_cr, ld_lg,
        ld_gt, rows_per_block);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t field = static_cast<int64_t>(n_chunks) * D;
  const dim3 sum_grid(static_cast<unsigned>((D + kSumThreads - 1)
                                            / kSumThreads));
  float* outs[3] = {d_cr, d_lg, d_gt};
  const long long lds[3] = {ld_cr, ld_lg, ld_gt};
  for (int f = 0; f < 3; ++f) {
    if (outs[f] != nullptr && lds[f] == 0) {
      column_sum_kernel<<<sum_grid, kSumThreads, 0, s>>>(
          partial + f * field, outs[f], n_chunks, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

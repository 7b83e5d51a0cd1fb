// Speed-of-light probes of the ZINB forward's tiling, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU probe kernels of benchmarks/kernel_probe.py:
//   elemwise_probe <- _elemwise_probe_kernel (inner `kernel`, :83)
//   lgamma_probe   <- _lgamma_probe_kernel (inner `kernel`, :131)
// Each computes what the TPU probe computes, a masked row sum over four
// (B, D) float32 operands x, a, b, c, with one body per element:
//   elemwise_probe: acc = x, then NFMA times acc = acc * a + b (fused);
//   lgamma_probe:   lgamma(x + a + 1) by Lanczos (g = 7, its series written
//                   in x itself, as zinb_pallas.py _lgamma_lanczos), by
//                   Stirling after a shift by 8 (_lgamma_stirling), or by
//                   CUDA's lgammaf (the one the ZINB kernels use).
//
// The point of a probe is to price the port's production tiling, so the
// loop is zinb_rowsum_fwd_kernel's (zinb.cu) with its per-element body
// replaced: the same launch plan (ops/zinb.py _launch_plan: grid rows x
// column chunks, 8 warps a block taking 128-column tiles in turn), the same
// tile loader and two-stage cp.async ring per warp (tile_ring.cuh), the
// same warp and block sums and the same ordered second pass over chunk
// partials (row_chunk_sum_kernel). Columns at or past D are not copied and
// are masked out of the sum.
//
// Every probe reads all four streams, 16 bytes an element, as the TPU
// probe's DMA does. The TPU kernels never read some operands (c; b and c
// for lgamma), and a kernel that does not read an operand moves fewer
// bytes and reports a false ceiling. So the unread operands are folded
// into each element as fmaf(c, 0.0f, v): under IEEE rules c * 0 is not 0
// for an infinite or NaN c, so the compiler cannot drop the load (nvcc
// does not assume finite math without --use_fast_math), and a NaN planted
// in c reaches its row's sum (the card test checks that); for finite c it
// adds +-0 and leaves v unchanged.
//
// What bounds them on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s float32):
// the bytes, 16 an element, for NFMA = 1 and for every lgamma variant;
// 64 FMAs (128 flops per 16 bytes, 8 flop/byte) is still below the card's
// ridge of ~20 flop/byte, so NFMA = 256 (32 flop/byte) is the instance that
// prices the FMA pipe. NFMA is a template parameter, so the chain is fully
// unrolled with no loop counter in it.
//
// Build: with zinb.cu (see ops/_build.py). Each entry point launches on
// the given stream, does not synchronize and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.91893853320467274f;  // 0.5 * log(2 pi)

// Lanczos g = 7, zinb_pallas.py _LANCZOS, each series term written in x:
// z + (i + 1) == x + i exactly, where (x - 1) + 1 would round a tiny x to 0.
__device__ __forceinline__ float lgamma_lanczos(float x) {
  float a = 0.99999999999980993f;
  a += 676.5203681218851f / x;
  a += -1259.1392167224028f / (x + 1.0f);
  a += 771.32342877765313f / (x + 2.0f);
  a += -176.61502916214059f / (x + 3.0f);
  a += 12.507343278686905f / (x + 4.0f);
  a += -0.13857109526572012f / (x + 5.0f);
  a += 9.9843695780195716e-6f / (x + 6.0f);
  a += 1.5056327351493116e-7f / (x + 7.0f);
  const float t = x + 6.5f;  // z + g + 1/2 == x + (g - 1/2)
  return kHalfLog2Pi + (x - 0.5f) * logf(t) - t + logf(a);
}

// lgamma(x) = lgamma(x + 8) - log prod_{k<8}(x + k), Stirling at y = x + 8,
// each factor scaled by 1/y so the product never overflows
// (zinb_pallas.py _lgamma_stirling).
__device__ __forceinline__ float lgamma_stirling(float x) {
  const float y = x + 8.0f;
  const float inv = 1.0f / y;
  const float p = (x * inv) * ((x + 1.0f) * inv) * ((x + 2.0f) * inv)
      * ((x + 3.0f) * inv) * ((x + 4.0f) * inv) * ((x + 5.0f) * inv)
      * ((x + 6.0f) * inv) * ((x + 7.0f) * inv);
  const float inv2 = inv * inv;
  const float series =
      inv * (1.0f / 12.0f - inv2 * (1.0f / 360.0f - inv2 * (1.0f / 1260.0f)));
  return (y - 8.5f) * logf(y) - y + kHalfLog2Pi - logf(p) + series;
}

// The per-element bodies: KIND 0 the FMA chain, 1 Lanczos, 2 Stirling,
// 3 lgammaf.
template <int KIND, int NFMA>
__device__ __forceinline__ float probe_elem(float x, float a, float b,
                                            float c) {
  float v;
  if (KIND == 0) {
    v = x;
#pragma unroll
    for (int i = 0; i < NFMA; ++i) v = fmaf(v, a, b);
    return fmaf(c, 0.0f, v);  // c is read (see the header)
  }
  const float arg = x + a + 1.0f;
  v = KIND == 1 ? lgamma_lanczos(arg)
                : (KIND == 2 ? lgamma_stirling(arg) : lgammaf(arg));
  return fmaf(b, 0.0f, fmaf(c, 0.0f, v));  // b and c are read
}

// zinb_rowsum_fwd_kernel's loop with probe_elem as its body. Block (row,
// chunk); the block's sum goes to out[row] when a row is one chunk, else to
// partial[row, chunk] for row_chunk_sum_kernel.
template <int KIND, int NFMA, bool VEC>
__global__ void __launch_bounds__(kThreads)
probe_rowsum_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ c,
                    float* __restrict__ out, float* __restrict__ partial,
                    int D, int tiles_per_chunk) {
  __shared__ __align__(16) float smem[kWarps][kStages][4][kTile];
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  const void* const src[4] = {x + row * D, a + row * D, b + row * D,
                              c + row * D};
  const int tiles = static_cast<int>((D + int64_t{kTile} - 1) / kTile);
  const int t0 = blockIdx.y * tiles_per_chunk + warp;
  const int t1 = min(tiles, static_cast<int>(blockIdx.y + 1) * tiles_per_chunk);
  float acc = 0.0f;
  auto issue = [&](int stage, int t) {
    if (t < t1) {
      issue_tile<VEC>(smem[warp][stage], src,
                      static_cast<int64_t>(t) * kTile + lane * kVec, D, lane,
                      0u);
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
    const float (*st)[kTile] = smem[warp][s];
    const int64_t col = static_cast<int64_t>(t) * kTile + lane * kVec;
    const float4 xv = ld4(&st[0][lane * kVec]);
    const float4 av = ld4(&st[1][lane * kVec]);
    const float4 bv = ld4(&st[2][lane * kVec]);
    const float4 cv = ld4(&st[3][lane * kVec]);
    const float xs[kVec] = {xv.x, xv.y, xv.z, xv.w};
    const float as[kVec] = {av.x, av.y, av.z, av.w};
    const float bs[kVec] = {bv.x, bv.y, bv.z, bv.w};
    const float cs[kVec] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float v = probe_elem<KIND, NFMA>(xs[k], as[k], bs[k], cs[k]);
      if (col + k < D) acc += v;
    }
    __syncwarp();  // every lane is done with stage s
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
    if (lane == 0) {
      if (gridDim.y == 1) {
        out[row] = acc;
      } else {
        partial[row * gridDim.y + blockIdx.y] = acc;
      }
    }
  }
}

template <int KIND, int NFMA>
int launch_probe(const float* x, const float* a, const float* b,
                 const float* c, float* out, float* partial, int B, int D,
                 int vec, int tiles_per_chunk, int n_chunks, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(n_chunks));
  auto kernel = vec ? probe_rowsum_kernel<KIND, NFMA, true>
                    : probe_rowsum_kernel<KIND, NFMA, false>;
  kernel<<<grid, kThreads, 0, s>>>(x, a, b, c, out, partial, D,
                                   tiles_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  row_chunk_sum_kernel<<<(B + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                         s>>>(partial, out, B, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[b] = sum_j elem(x[b, j], a[b, j], b[b, j], c[b, j]) over contiguous
// (B, D) float32 operands. `vec`, `tiles_per_chunk` and `n_chunks` come
// from the forward's launch plan (ops/zinb.py _launch_plan); with more
// than one chunk, `partial` holds B * n_chunks floats. n_fma is 1, 64 or
// 256 (the instances built); another value returns cudaErrorInvalidValue.
int sisua_elemwise_probe(const float* x, const float* a, const float* b,
                         const float* c, float* out, float* partial, int B,
                         int D, int vec, int tiles_per_chunk, int n_chunks,
                         int n_fma, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fma) {
    case 1:
      return launch_probe<0, 1>(x, a, b, c, out, partial, B, D, vec,
                                tiles_per_chunk, n_chunks, s);
    case 64:
      return launch_probe<0, 64>(x, a, b, c, out, partial, B, D, vec,
                                 tiles_per_chunk, n_chunks, s);
    case 256:
      return launch_probe<0, 256>(x, a, b, c, out, partial, B, D, vec,
                                  tiles_per_chunk, n_chunks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same with lgamma(x + a + 1): which 0 Lanczos, 1 Stirling, 2 lgammaf.
int sisua_lgamma_probe(const float* x, const float* a, const float* b,
                       const float* c, float* out, float* partial, int B,
                       int D, int vec, int tiles_per_chunk, int n_chunks,
                       int which, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0:
      return launch_probe<1, 0>(x, a, b, c, out, partial, B, D, vec,
                                tiles_per_chunk, n_chunks, s);
    case 1:
      return launch_probe<2, 0>(x, a, b, c, out, partial, B, D, vec,
                                tiles_per_chunk, n_chunks, s);
    case 2:
      return launch_probe<3, 0>(x, a, b, c, out, partial, B, D, vec,
                                tiles_per_chunk, n_chunks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

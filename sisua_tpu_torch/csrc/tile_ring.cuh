// The tile loader and row reduction that the forward ZINB kernel
// (zinb.cu) and the probe kernels (probe.cu) share, so that a probe prices
// the production tiling: the same 128-column warp tiles of four operand
// rows, streamed with cp.async through a two-stage ring in shared memory
// (16-byte copies where every row start is 16-byte aligned, 4-byte copies
// otherwise; bf16 operands as 8-byte copies or 2-byte loads), the same
// warp and block sums, and the same ordered second pass over column-chunk
// partials. Included by each source into its own anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;                  // consecutive columns per lane
constexpr int kTile = 32 * kVec;         // columns per warp tile
constexpr int kStages = 2;               // cp.async ring depth per warp
constexpr int kSumThreads = 256;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest kStages - 1 groups have landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// Whether operand `op` (0 x, 1 theta operand, 2 logits, 3 gate) is bf16:
// bit op - 1 of the call's mask; x is always float32.
__device__ __forceinline__ bool is_bf16(unsigned bf, int op) {
  return op > 0 && ((bf >> (op - 1)) & 1u);
}

// Copy one lane's kVec columns [c, c + kVec) of the four operand rows into
// the stage; columns at or past D are not copied (and are masked later).
// `src` are the rows' first elements, float or bf16 as `bf` says; a bf16
// tile fills the first half of its operand's slot.
template <bool VEC>
__device__ __forceinline__ void issue_tile(float (*dst)[kTile],
                                           const void* const src[4],
                                           int64_t c, int64_t D, int lane,
                                           unsigned bf) {
#pragma unroll
  for (int op = 0; op < 4; ++op) {
    if (is_bf16(bf, op)) {
      unsigned short* d =
          reinterpret_cast<unsigned short*>(dst[op]) + lane * kVec;
      const unsigned short* s =
          static_cast<const unsigned short*>(src[op]) + c;
      if (VEC) {
        if (c < D) cp_async8(d, s);  // rows 8-byte aligned on this path
      } else {
        // no 2-byte cp.async: ordinary loads, which the warp barrier after
        // the ring's wait makes visible to the warp like the copies
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (c + k < D) d[k] = __ldg(s + k);
        }
      }
      continue;
    }
    float* d = &dst[op][lane * kVec];
    const float* s = static_cast<const float*>(src[op]) + c;
    if (VEC) {
      if (c < D) cp_async16(d, s);  // D % 4 == 0 on this path
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (c + k < D) cp_async4(d + k, s + k);
      }
    }
  }
  cp_async_commit();  // an empty group is fine: the ring counts groups
}


// The float value of a bf16's bits (exact: they are a float's high half)
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// A lane's kVec staged values of one operand, widened to float32
__device__ __forceinline__ void stage_vals(const float* slot, bool bf16,
                                           int i0, float (&v)[kVec]) {
  if (bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned short*>(slot) + i0);
    v[0] = bf16_bits_to_float(u.x & 0xffffu);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = bf16_bits_to_float(u.y & 0xffffu);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(slot + i0);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}


// The row start of operand `op` in bytes: `base` + row * stride elements
__device__ __forceinline__ const void* row_ptr(const void* base,
                                               int64_t row, int64_t ld,
                                               bool bf16) {
  return static_cast<const char*>(base) + row * ld * (bf16 ? 2 : 4);
}


__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}


// out[b] = sum over chunks c, in order, of partial[b, c]
__global__ void __launch_bounds__(kSumThreads)
row_chunk_sum_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, int B, int n_chunks) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSumThreads
      + threadIdx.x;
  if (row >= B) return;
  const float* p = partial + row * n_chunks;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += p[c];
  out[row] = s;
}

}  // namespace

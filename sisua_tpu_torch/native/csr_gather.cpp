// Host-side row gathers of the port's data path (the port's own copy of
// sisua_tpu/native/csr_gather.cpp, whose functions it keeps one for one).
//
// The training data stays on the host as a CSR count matrix (or a dense
// float32 one); each streamed batch or out-of-core chunk gathers its
// shuffled rows into a dense row-major float32 buffer, which the trainer
// uploads to the card. One tight memset/scatter (or memcpy) loop per row,
// where scipy's fancy indexing allocates per batch and walks Python and
// NumPy dispatch.
//
// Build: g++ -O3 -shared -fPIC csr_gather.cpp (see native/__init__.py).
// The caller (native/__init__.py) coerces every array to the ABI below
// (float32 values, int64 indices, C-contiguous) and checks `out`.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Gather CSR rows[0..n_rows) into a dense row-major out[n_rows, n_cols].
void csr_gather_f32(const float* __restrict data,
                    const int64_t* __restrict indices,
                    const int64_t* __restrict indptr,
                    const int64_t* __restrict rows, int64_t n_rows,
                    int64_t n_cols, float* __restrict out) {
  for (int64_t r = 0; r < n_rows; ++r) {
    float* dst = out + r * n_cols;
    std::memset(dst, 0, sizeof(float) * n_cols);
    const int64_t row = rows[r];
    const int64_t lo = indptr[row], hi = indptr[row + 1];
    for (int64_t k = lo; k < hi; ++k) dst[indices[k]] = data[k];
  }
}

// The same, with log1p applied to each stored value.
void csr_gather_log1p_f32(const float* __restrict data,
                          const int64_t* __restrict indices,
                          const int64_t* __restrict indptr,
                          const int64_t* __restrict rows, int64_t n_rows,
                          int64_t n_cols, float* __restrict out) {
  for (int64_t r = 0; r < n_rows; ++r) {
    float* dst = out + r * n_cols;
    std::memset(dst, 0, sizeof(float) * n_cols);
    const int64_t row = rows[r];
    const int64_t lo = indptr[row], hi = indptr[row + 1];
    for (int64_t k = lo; k < hi; ++k) dst[indices[k]] = std::log1p(data[k]);
  }
}

// Dense row gather: out[r] = src[rows[r]].
void dense_gather_f32(const float* __restrict src,
                      const int64_t* __restrict rows, int64_t n_rows,
                      int64_t n_cols, float* __restrict out) {
  for (int64_t r = 0; r < n_rows; ++r) {
    std::memcpy(out + r * n_cols, src + rows[r] * n_cols,
                sizeof(float) * n_cols);
  }
}

}  // extern "C"

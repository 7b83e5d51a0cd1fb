// The LARS-Lasso path on a precomputed Gram matrix: sklearn 1.9's
// ``_lars_path_solver`` (sklearn/linear_model/_least_angle.py) in 'lasso'
// mode with ``Gram`` given, ``return_path=False`` and ``positive=False``,
// statement by statement in the input's precision (float or double), with
// sklearn's quirks kept: the stopping threshold ``alpha_min + eps32`` is
// rounded to float32 as numpy's promotion rounds it, the direction's
// correlations are rounded to ``finfo.precision`` decimals, a degenerate
// regressor is dropped without undoing its swaps, and a dropped variable's
// correlation is recomputed from the original Gram and Xy.
//
// One path per target (a gene, when ``sparse_encode`` codes a dictionary):
// targets are independent, so OpenMP runs them in parallel; each path is
// sequential. Plain C interface for ctypes:
//   void lars_lasso_gram_{f32,f64}(const T* gram (k x k),
//       const T* xy (n_targets x k), int64 n_targets, int64 k,
//       int64 n_samples, double alpha_min, int64 max_iter, double eps,
//       int32 num_threads (≤ 0: OpenMP's default team),
//       T* coef (n_targets x k), T* alpha (n_targets),
//       int64* n_iter (n_targets), int64* active (n_targets x k, -1 padded))
#include <omp.h>

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

template <typename T>
struct Prec;
template <>
struct Prec<float> {
  static constexpr float kRound = 1e6f;  // 10 ** finfo(float32).precision
};
template <>
struct Prec<double> {
  static constexpr double kRound = 1e15;  // 10 ** finfo(float64).precision
};

template <typename T>
T min_pos(const T* x, int64_t n) {  // sklearn.utils.arrayfuncs.min_pos
  T m = std::numeric_limits<T>::max();
  for (int64_t i = 0; i < n; ++i)
    if (T(0) < x[i] && x[i] < m) m = x[i];
  return m;
}

template <typename T>
void rotg(T* a, T* b, T* c, T* s) {  // BLAS xROTG (reference 3.10)
  const T safmin = std::numeric_limits<T>::min();
  const T safmax = T(1) / safmin;
  const T anorm = std::fabs(*a), bnorm = std::fabs(*b);
  if (bnorm == T(0)) {
    *c = 1;
    *s = 0;
    *b = 0;
  } else if (anorm == T(0)) {
    *c = 0;
    *s = 1;
    *a = *b;
    *b = 1;
  } else {
    const T scl = std::min(safmax, std::max(safmin, std::max(anorm, bnorm)));
    const T sigma = anorm > bnorm ? std::copysign(T(1), *a)
                                  : std::copysign(T(1), *b);
    const T ra = *a / scl, rb = *b / scl;
    const T r = sigma * (scl * std::sqrt(ra * ra + rb * rb));
    *c = *a / r;
    *s = *b / r;
    T z;
    if (anorm > bnorm)
      z = *s;
    else if (*c != T(0))
      z = T(1) / *c;
    else
      z = T(1);
    *a = r;
    *b = z;
  }
}

// sklearn.utils.arrayfuncs.cholesky_delete on the n x n view of L (row
// stride m)
template <typename T>
void cholesky_delete(T* L, int64_t n, int64_t m, int64_t go_out) {
  T* L1 = L + go_out * m;
  for (int64_t i = go_out; i < n - 1; ++i) {
    std::copy(L1 + m, L1 + m + i + 2, L1);
    L1 += m;
  }
  L1 = L + go_out * m;
  for (int64_t i = go_out; i < n - 1; ++i) {
    T c, s;
    rotg(L1 + i, L1 + i + 1, &c, &s);
    if (L1[i] < 0) {
      L1[i] = std::fabs(L1[i]);
      c = -c;
      s = -s;
    }
    L1[i + 1] = 0;
    L1 += m;
    T* x = L1 + i;
    T* y = L1 + i + 1;
    for (int64_t r = 0; r < n - i - 2; ++r) {  // BLAS xROT, stride m
      const T tx = x[r * m], ty = y[r * m];
      x[r * m] = c * tx + s * ty;
      y[r * m] = c * ty - s * tx;
    }
  }
}

template <typename T>
T dot(const T* a, const T* b, int64_t n) {
  T s = 0;
  for (int64_t i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// L[:n, :n] lower, solve L x = b in place (LAPACK xTRTRS, no transpose)
template <typename T>
void forward(const T* L, int64_t ld, int64_t n, T* b) {
  for (int64_t i = 0; i < n; ++i) {
    T s = b[i];
    for (int64_t j = 0; j < i; ++j) s -= L[i * ld + j] * b[j];
    b[i] = s * (T(1) / L[i * ld + i]);
  }
}

// L Lᵀ x = b (LAPACK xPOTRS with the lower factor)
template <typename T>
void potrs(const T* L, int64_t ld, int64_t n, T* b) {
  forward(L, ld, n, b);
  for (int64_t i = n - 1; i >= 0; --i) {
    T s = b[i];
    for (int64_t j = i + 1; j < n; ++j) s -= L[j * ld + i] * b[j];
    b[i] = s * (T(1) / L[i * ld + i]);
  }
}

template <typename T>
void swap_rows_cols(T* G, int64_t nf, int64_t a, int64_t b) {
  for (int64_t j = 0; j < nf; ++j) std::swap(G[a * nf + j], G[b * nf + j]);
  for (int64_t i = 0; i < nf; ++i) std::swap(G[i * nf + a], G[i * nf + b]);
}

template <typename T>
void lars_one(const T* gram0, const T* xy0, int64_t nf, int64_t n_samples,
              double alpha_min, int64_t max_iter, double eps, T* coef_out,
              T* alpha_out, int64_t* n_iter_out, int64_t* active_out) {
  const T tiny32 = FLT_MIN;
  const float equality_tolerance = FLT_EPSILON;
  // numpy: python float + np.float32 is computed in float32
  const float stop_at = static_cast<float>(alpha_min) + equality_tolerance;
  const T alpha_min_t = static_cast<T>(alpha_min);
  const int64_t max_features = std::min(max_iter, nf);

  std::vector<T> cov(xy0, xy0 + nf);  // the live Cov is cov[cs:]
  int64_t cs = 0;
  std::vector<T> gram(gram0, gram0 + nf * nf);
  std::vector<int64_t> indices(nf);
  for (int64_t i = 0; i < nf; ++i) indices[i] = i;
  std::vector<T> L(std::max<int64_t>(max_features, 1) *
                   std::max<int64_t>(max_features, 1), T(0));
  const int64_t ld = std::max<int64_t>(max_features, 1);
  std::vector<int8_t> sign_active(std::max<int64_t>(max_features, 1), 0);
  std::vector<int64_t> active;
  std::vector<T> coef(nf, T(0)), prev_coef(nf, T(0));
  T alpha = 0, prev_alpha = 0;
  int64_t n_iter = 0, n_active = 0;
  bool drop = false;
  bool signs_f64 = sizeof(T) == sizeof(double);
  std::vector<int64_t> idx;
  std::vector<T> least_squares, corr_eq_dir, z;

  while (true) {
    const int64_t ncov = nf - cs;
    T C = 0, C_ = 0;
    int64_t C_idx = 0;
    if (ncov > 0) {
      T best = -1;
      for (int64_t j = 0; j < ncov; ++j) {
        const T a = std::fabs(cov[cs + j]);
        if (a > best) {
          best = a;
          C_idx = j;
        }
      }
      C_ = cov[cs + C_idx];
      C = std::fabs(C_);
    }
    alpha = C / static_cast<T>(n_samples);
    if (static_cast<double>(alpha) <= static_cast<double>(stop_at)) {
      T diff = static_cast<T>(alpha - alpha_min_t);
      if (sizeof(T) == sizeof(double))
        diff = static_cast<T>(static_cast<double>(alpha) - alpha_min);
      if (static_cast<double>(std::fabs(diff)) >
          static_cast<double>(equality_tolerance)) {
        if (n_iter > 0) {
          T ss;
          if (sizeof(T) == sizeof(double))
            ss = static_cast<T>((static_cast<double>(prev_alpha) - alpha_min) /
                                (prev_alpha - alpha));
          else
            ss = (prev_alpha - alpha_min_t) / (prev_alpha - alpha);
          for (int64_t j = 0; j < nf; ++j)
            coef[j] = prev_coef[j] + ss * (coef[j] - prev_coef[j]);
        }
        alpha = alpha_min_t;
      }
      break;
    }
    if (n_iter >= max_iter || n_active >= nf) break;
    if (!drop) {
      sign_active[n_active] = C_ > 0 ? 1 : (C_ < 0 ? -1 : 0);
      const int64_t m = n_active, n = C_idx + n_active;
      std::swap(cov[cs + C_idx], cov[cs]);
      std::swap(indices[n], indices[m]);
      const int64_t cs_not_shortened = cs;
      cs += 1;
      swap_rows_cols(gram.data(), nf, m, n);
      const T c = gram[n_active * nf + n_active];
      T* Lrow = L.data() + n_active * ld;
      for (int64_t j = 0; j < n_active; ++j) Lrow[j] = gram[n_active * nf + j];
      if (n_active) forward(L.data(), ld, n_active, Lrow);
      const T v = dot(Lrow, Lrow, n_active);
      const T root = std::sqrt(std::fabs(c - v));
      const double diag = std::max(static_cast<double>(root), eps);
      Lrow[n_active] = static_cast<T>(diag);
      if (diag < 1e-7) {  // degenerate: dropped for good, swaps kept
        cs = cs_not_shortened;
        cov[cs] = 0;
        std::swap(cov[cs + C_idx], cov[cs]);
        continue;
      }
      active.push_back(indices[n_active]);
      n_active += 1;
    }
    if (n_iter > 0 && prev_alpha < alpha) break;  // alpha increasing

    // After a drop numpy's ``np.append(sign_active, 0.0)`` leaves the signs
    // float64, which promotes AA, the step ratios and C / AA to float64
    // on a float32 path (all of it is float64 on a float64 path anyway).
    least_squares.assign(n_active, T(0));
    for (int64_t i = 0; i < n_active; ++i)
      least_squares[i] = static_cast<T>(sign_active[i]);
    potrs(L.data(), ld, n_active, least_squares.data());
    bool aa64 = signs_f64;
    double AA;
    if (n_active == 1 && least_squares[0] == T(0)) {
      least_squares[0] = 1;
      AA = 1;
      aa64 = false;  // a Python 1.0 takes the array's type
    } else {
      double sum_d = 0;
      T sum_t = 0;
      for (int64_t i = 0; i < n_active; ++i) {
        sum_d += static_cast<double>(least_squares[i]) * sign_active[i];
        sum_t += least_squares[i] * static_cast<T>(sign_active[i]);
      }
      AA = aa64 ? 1.0 / std::sqrt(sum_d)
                : static_cast<double>(T(1) / std::sqrt(sum_t));
      if (!std::isfinite(AA)) {  // L too ill-conditioned
        std::vector<T> L_(L);
        for (int i = 0; !std::isfinite(AA); ++i) {
          for (int64_t d = 0; d < n_active; ++d)
            L_[d * ld + d] += static_cast<T>(std::ldexp(eps, i));
          for (int64_t d = 0; d < n_active; ++d)
            least_squares[d] = static_cast<T>(sign_active[d]);
          potrs(L_.data(), ld, n_active, least_squares.data());
          double tmp = 0;
          for (int64_t d = 0; d < n_active; ++d)
            tmp += static_cast<double>(least_squares[d]) * sign_active[d];
          AA = 1.0 / std::sqrt(std::max(tmp, eps));
        }
      }
      for (int64_t i = 0; i < n_active; ++i)
        least_squares[i] = aa64 ? static_cast<T>(least_squares[i] * AA)
                                : least_squares[i] * static_cast<T>(AA);
    }
    // correlations of the inactive variables with the direction, rounded
    const int64_t n_in = nf - n_active;
    corr_eq_dir.assign(n_in, T(0));
    for (int64_t j = 0; j < n_in; ++j) {
      T s = 0;
      for (int64_t i = 0; i < n_active; ++i)
        s += gram[i * nf + n_active + j] * least_squares[i];
      corr_eq_dir[j] = std::nearbyint(s * Prec<T>::kRound) / Prec<T>::kRound;
    }
    const T AA_t = static_cast<T>(AA);
    auto step = [&](T num, T corr, bool plus) -> double {
      if (aa64)
        return num / ((plus ? AA + corr : AA - corr) + static_cast<double>(
                                                           tiny32));
      return static_cast<double>(
          num / ((plus ? AA_t + corr : AA_t - corr) + tiny32));
    };
    // min_pos starts at the largest value of its array's type
    double g1 = aa64 ? std::numeric_limits<double>::max()
                     : static_cast<double>(std::numeric_limits<T>::max());
    double g2 = g1;
    for (int64_t j = 0; j < n_in; ++j) {  // min_pos over each ratio
      const double r1 = step(C - cov[cs + j], corr_eq_dir[j], false);
      const double r2 = step(C + cov[cs + j], corr_eq_dir[j], true);
      if (0. < r1 && r1 < g1) g1 = r1;
      if (0. < r2 && r2 < g2) g2 = r2;
    }
    const double c_over_aa = aa64 ? static_cast<double>(C) / AA
                                  : static_cast<double>(C / AA_t);
    // Python's min keeps the first of equal values; only C / AA is a
    // numpy float64 (a strong type) when aa64
    double gamma = g1;
    bool strong = false;
    if (g2 < gamma) gamma = g2;
    if (c_over_aa < gamma) {
      gamma = c_over_aa;
      strong = aa64;
    }

    drop = false;
    z.assign(n_active, T(0));
    for (int64_t i = 0; i < n_active; ++i)
      z[i] = -coef[active[i]] / (least_squares[i] + tiny32);
    const T z_pos = min_pos(z.data(), n_active);
    idx.clear();
    if (static_cast<double>(z_pos) < gamma) {  // coefficients changed sign
      for (int64_t i = n_active - 1; i >= 0; --i)
        if (z[i] == z_pos) idx.push_back(i);
      for (int64_t i : idx) sign_active[i] = -sign_active[i];
      gamma = z_pos;
      strong = false;
      drop = true;
    }
    n_iter += 1;
    prev_coef.swap(coef);
    prev_alpha = alpha;
    std::fill(coef.begin(), coef.end(), T(0));
    const T gamma_t = static_cast<T>(gamma);
    for (int64_t i = 0; i < n_active; ++i) {
      const int64_t a = active[i];
      coef[a] = strong ? static_cast<T>(prev_coef[a] +
                                        gamma * least_squares[i])
                       : prev_coef[a] + gamma_t * least_squares[i];
    }
    for (int64_t j = 0; j < n_in; ++j)
      cov[cs + j] = strong ? static_cast<T>(cov[cs + j] -
                                            gamma * corr_eq_dir[j])
                           : cov[cs + j] - gamma_t * corr_eq_dir[j];

    if (drop) {
      for (int64_t ii : idx) cholesky_delete(L.data(), n_active, ld, ii);
      n_active -= 1;
      std::vector<int64_t> drop_idx;
      for (int64_t ii : idx) {
        drop_idx.push_back(active[ii]);
        active.erase(active.begin() + ii);
      }
      for (int64_t ii : idx)
        for (int64_t i = ii; i < n_active; ++i) {
          std::swap(indices[i], indices[i + 1]);
          swap_rows_cols(gram.data(), nf, i, i + 1);
        }
      const int64_t nd = static_cast<int64_t>(drop_idx.size());
      cs -= nd;
      for (int64_t t = 0; t < nd; ++t) {
        const int64_t d = drop_idx[t];
        cov[cs + t] = xy0[d] - dot(gram0 + d * nf, coef.data(), nf);
      }
      for (int64_t ii : idx)  // np.delete, then one 0.0 appended
        sign_active.erase(sign_active.begin() + ii);
      sign_active.push_back(0);
      signs_f64 = sizeof(T) == sizeof(float);
    }
  }
  std::copy(coef.begin(), coef.end(), coef_out);
  *alpha_out = alpha;
  *n_iter_out = n_iter;
  for (int64_t i = 0; i < nf; ++i)
    active_out[i] = i < static_cast<int64_t>(active.size()) ? active[i] : -1;
}

template <typename T>
void lars_batch(const T* gram, const T* xy, int64_t n_targets, int64_t k,
                int64_t n_samples, double alpha_min, int64_t max_iter,
                double eps, int32_t num_threads, T* coef, T* alpha,
                int64_t* n_iter, int64_t* active) {
  if (num_threads <= 0) num_threads = omp_get_max_threads();
#pragma omp parallel for num_threads(num_threads) schedule(dynamic, 16)
  for (int64_t t = 0; t < n_targets; ++t)
    lars_one<T>(gram, xy + t * k, k, n_samples, alpha_min, max_iter, eps,
                coef + t * k, alpha + t, n_iter + t, active + t * k);
}

}  // namespace

extern "C" {
void lars_lasso_gram_f32(const float* gram, const float* xy,
                         int64_t n_targets, int64_t k, int64_t n_samples,
                         double alpha_min, int64_t max_iter, double eps,
                         int32_t num_threads, float* coef, float* alpha,
                         int64_t* n_iter, int64_t* active) {
  lars_batch<float>(gram, xy, n_targets, k, n_samples, alpha_min, max_iter,
                    eps, num_threads, coef, alpha, n_iter, active);
}

void lars_lasso_gram_f64(const double* gram, const double* xy,
                         int64_t n_targets, int64_t k, int64_t n_samples,
                         double alpha_min, int64_t max_iter, double eps,
                         int32_t num_threads, double* coef, double* alpha,
                         int64_t* n_iter, int64_t* active) {
  lars_batch<double>(gram, xy, n_targets, k, n_samples, alpha_min, max_iter,
                     eps, num_threads, coef, alpha, n_iter, active);
}
}

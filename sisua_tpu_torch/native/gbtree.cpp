// One regression tree of sklearn's DepthFirstTreeBuilder (best splitter,
// squared error, min_samples_split 2, min_samples_leaf 1), step for step
// as ``analysis/estimators.py``'s ``_TreeBuilder``, its plain reference:
// the features each node visits in the order sklearn's rand_r draws them,
// the samples array each visit sorts (the presorted rows filtered by
// membership) and the final split partitions, and every sum in the
// criterion's order (sequential, from the node's first sample, or from
// the node total backwards where sklearn restarts). Built with
// -ffp-contract=off: no multiply-add may be fused, so every product and
// sum rounds as numpy's do.
#include <math.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

const double kFeatureThreshold = 1e-7;
const double kEps64 = std::numeric_limits<double>::epsilon();
const uint32_t kRandRMax = 2147483647u;

// libm's pow, as Python's ``x ** 2.0`` calls it: through a pointer, so the
// compiler cannot fold pow(x, 2.0) into x * x (they can differ by an ulp)
double (*volatile libm_pow)(double, double) = ::pow;

struct RandR {
  uint32_t state;
  int64_t rand_int(int64_t low, int64_t high) {
    uint32_t s = state ? state : 1u;
    s ^= s << 13;
    s ^= s >> 17;
    s ^= s << 5;
    state = s;
    return low + (int64_t)((s % (kRandRMax + 1u)) % (uint64_t)(high - low));
  }
};

double seq_sum(const double* a, int64_t m) {
  if (m == 0) return 0.0;
  double acc = a[0];
  for (int64_t i = 1; i < m; ++i) acc += a[i];
  return acc;
}

// sklearn's sum_left at each split position pos[0..k) (ascending) of one
// feature's node values ys[0..m): running sums from the first sample,
// except where a position lies nearer the end than the one before, where
// the sum restarts from the node total, subtracts from the end, and runs
// on from there.
void left_sums(const double* ys, int64_t m, const int64_t* pos, int64_t k,
               double total, double* out) {
  int64_t prev = 0;
  bool started = false;  // a running sum is in hand
  double acc = 0.0;
  int64_t at = 0;        // acc = the sum of ys[0..at) in sklearn's order
  for (int64_t r = 0; r < k; ++r) {
    int64_t p = pos[r];
    if (p - prev > m - p) {
      double base = total;
      for (int64_t i = m - 1; i >= p; --i) base -= ys[i];
      acc = base;
      at = p;
      started = true;
    } else {
      if (!started) {
        acc = ys[0];
        at = 1;
        started = true;
      }
      for (; at < p; ++at) acc += ys[at];
    }
    out[r] = acc;
    prev = p;
  }
}

struct Builder {
  const float* X;
  int64_t n, d;
  const int64_t* order;  // (d, n): each feature's rows in ascending order
  int64_t max_depth;
  RandR rng;
  const double* w;
  const double* y;
  std::vector<double> wy;
  std::vector<int64_t> samples, features, constant;
  std::vector<char> member;
  std::vector<int64_t> seg, last_seg, pos;
  std::vector<double> xs, ys, ws, sl, wl;

  double x(int64_t row, int64_t f) const { return (double)X[row * d + f]; }

  // node_split_best on samples[start, end): false when no split; else
  // (feature, position, threshold). n_known in, the children's constant
  // count out.
  bool split(int64_t start, int64_t end, int64_t& n_known, int64_t& best_f,
             int64_t& best_pos, double& best_thr) {
    int64_t m = end - start;
    std::vector<double> tmp(m);
    for (int64_t i = 0; i < m; ++i) tmp[i] = wy[samples[start + i]];
    double total = seq_sum(tmp.data(), m);
    for (int64_t i = 0; i < m; ++i) tmp[i] = w[samples[start + i]];
    double w_total = seq_sum(tmp.data(), m);
    for (int64_t i = start; i < end; ++i) member[samples[i]] = 1;
    int64_t* feats = features.data();
    bool have_last = false, found_split = false;
    int64_t f_i = d, visited = 0, found = 0, drawn = 0, n_total = n_known;
    double best_proxy = -std::numeric_limits<double>::infinity();
    seg.resize(m);
    xs.resize(m);
    while (f_i > n_total && (visited < d || visited <= found + drawn)) {
      ++visited;
      int64_t f_j = rng.rand_int(drawn, f_i - found);
      if (f_j < n_known) {
        std::swap(feats[drawn], feats[f_j]);
        ++drawn;
        continue;
      }
      f_j += found;
      int64_t f = feats[f_j];
      const int64_t* o = order + f * n;
      int64_t c = 0;
      for (int64_t i = 0; i < n; ++i)
        if (member[o[i]]) seg[c++] = o[i];
      last_seg.assign(seg.begin(), seg.end());
      have_last = true;
      for (int64_t i = 0; i < m; ++i) xs[i] = x(seg[i], f);
      if (xs[m - 1] <= xs[0] + kFeatureThreshold) {
        std::swap(feats[f_j], feats[n_total]);
        ++found;
        ++n_total;
        continue;
      }
      --f_i;
      std::swap(feats[f_i], feats[f_j]);
      pos.clear();
      for (int64_t i = 1; i < m; ++i)
        if (xs[i] > xs[i - 1] + kFeatureThreshold) pos.push_back(i);
      int64_t k = (int64_t)pos.size();
      ys.resize(m);
      ws.resize(m);
      sl.resize(k);
      wl.resize(k);
      for (int64_t i = 0; i < m; ++i) {
        ys[i] = wy[seg[i]];
        ws[i] = w[seg[i]];
      }
      left_sums(ys.data(), m, pos.data(), k, total, sl.data());
      left_sums(ws.data(), m, pos.data(), k, w_total, wl.data());
      // numpy's argmax: the first maximum, or the first NaN
      int64_t arg = 0;
      double top = 0.0;
      for (int64_t r = 0; r < k; ++r) {
        double s_l = sl[r], s_r = total - s_l;
        double proxy = s_l * s_l / wl[r] + s_r * s_r / (w_total - wl[r]);
        if (std::isnan(proxy)) {
          arg = r;
          top = proxy;
          break;
        }
        if (r == 0 || proxy > top) {
          arg = r;
          top = proxy;
        }
      }
      if (top > best_proxy) {
        int64_t p = pos[arg];
        best_proxy = top;
        best_f = f;
        best_pos = start + p;
        best_thr = xs[p - 1] / 2.0 + xs[p] / 2.0;
        found_split = true;
      }
    }
    if (have_last)
      std::memcpy(samples.data() + start, last_seg.data(),
                  sizeof(int64_t) * m);
    for (int64_t i = start; i < end; ++i) member[samples[i]] = 0;
    for (int64_t i = 0; i < n_known; ++i) feats[i] = constant[i];
    for (int64_t i = n_known; i < n_known + found; ++i)
      constant[i] = feats[i];
    n_known = n_total;
    return found_split;
  }

  // partition_samples_final: from the front, a left-goer stays, a
  // right-goer swaps with the last unexamined sample
  void partition(int64_t start, int64_t end, int64_t f, double thr) {
    int64_t p = start, stop = end;
    while (p < stop) {
      if (x(samples[p], f) <= thr) {
        ++p;
      } else {
        --stop;
        std::swap(samples[p], samples[stop]);
      }
    }
  }
};

struct Frame {
  int64_t start, end, depth, parent;
  bool is_left;
  double impurity;
  int64_t n_const;
};

}  // namespace

extern "C" {

// Grows the tree; writes per node feature (-2 at a leaf), threshold
// (-2.0 at a leaf), left, right (-1 at a leaf), impurity, weighted
// n_samples and value, and each row's leaf (rows of weight 0: 0).
// Returns the node count, or -1 if it would exceed ``capacity``.
int64_t gbtree_build(const float* X, int64_t n, int64_t d,
                     const int64_t* order, const double* w, const double* y,
                     int64_t max_depth, uint32_t seed, int64_t capacity,
                     int64_t* feature, double* threshold, int64_t* left,
                     int64_t* right, double* impurity, double* n_samples,
                     double* value, int64_t* leaf_of) {
  Builder b;
  b.X = X;
  b.n = n;
  b.d = d;
  b.order = order;
  b.max_depth = max_depth;
  b.rng.state = seed;
  b.w = w;
  b.y = y;
  b.wy.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.wy[i] = w[i] * y[i];
    leaf_of[i] = 0;
    if (w[i] != 0.0) b.samples.push_back(i);
  }
  b.features.resize(d);
  for (int64_t f = 0; f < d; ++f) b.features[f] = f;
  b.constant.assign(d, 0);
  b.member.assign(n, 0);
  int64_t n_s = (int64_t)b.samples.size();
  std::vector<double> a(n_s), a2(n_s);
  auto sums = [&](int64_t start, int64_t end, double& wm, double& total,
                  double& sq_total) {
    int64_t m = end - start;
    for (int64_t i = 0; i < m; ++i) a[i] = w[b.samples[start + i]];
    wm = seq_sum(a.data(), m);
    for (int64_t i = 0; i < m; ++i) {
      int64_t s = b.samples[start + i];
      a[i] = b.wy[s];
      a2[i] = b.wy[s] * y[s];
    }
    total = seq_sum(a.data(), m);
    sq_total = seq_sum(a2.data(), m);
  };
  double w_n, total, sq_total;
  sums(0, n_s, w_n, total, sq_total);
  double root_imp = sq_total / w_n - libm_pow(total / w_n, 2.0);
  std::vector<Frame> stack{{0, n_s, 0, -1, false, root_imp, 0}};
  int64_t count = 0;
  while (!stack.empty()) {
    Frame fr = stack.back();
    stack.pop_back();
    int64_t start = fr.start, end = fr.end, m = end - start;
    double wm;
    sums(start, end, wm, total, sq_total);
    bool has_split = false;
    int64_t f = -1, pos = 0, n_const = fr.n_const;
    double thr = 0.0, imp_l = 0.0, imp_r = 0.0;
    if (!(fr.depth >= b.max_depth || m < 2 || fr.impurity <= kEps64))
      has_split = b.split(start, end, n_const, f, pos, thr);
    if (has_split) {
      b.partition(start, end, f, thr);
      int64_t nl = pos - start, nr = end - pos;
      auto left_of = [&](bool weighted, double whole) {
        for (int64_t i = 0; i < m; ++i) {
          int64_t s = b.samples[start + i];
          a[i] = weighted ? b.wy[s] : w[s];
        }
        if (nl <= nr) return seq_sum(a.data(), nl);
        double acc = whole;
        for (int64_t i = m - 1; i >= nl; --i) acc -= a[i];
        return acc;
      };
      double sl = left_of(true, total), wl = left_of(false, wm);
      double sr = total - sl, wr = wm - wl;
      for (int64_t i = 0; i < nl; ++i) {
        int64_t s = b.samples[start + i];
        a2[i] = b.wy[s] * y[s];
      }
      double sq_l = seq_sum(a2.data(), nl);
      imp_l = sq_l / wl - libm_pow(sl / wl, 2.0);
      imp_r = (sq_total - sq_l) / wr - libm_pow(sr / wr, 2.0);
      double gain = (wm / w_n) * (fr.impurity - wr / wm * imp_r
                                  - wl / wm * imp_l);
      if (gain + kEps64 < 0.0) has_split = false;
    }
    if (count >= capacity) return -1;
    int64_t node = count++;
    if (fr.parent >= 0) (fr.is_left ? left : right)[fr.parent] = node;
    impurity[node] = fr.impurity;
    n_samples[node] = wm;
    value[node] = total / wm;
    left[node] = -1;
    right[node] = -1;
    if (!has_split) {
      feature[node] = -2;
      threshold[node] = -2.0;
      for (int64_t i = start; i < end; ++i) leaf_of[b.samples[i]] = node;
      continue;
    }
    feature[node] = f;
    threshold[node] = thr;
    stack.push_back({pos, end, fr.depth + 1, node, false, imp_r, n_const});
    stack.push_back({start, pos, fr.depth + 1, node, true, imp_l, n_const});
  }
  return count;
}

}  // extern "C"

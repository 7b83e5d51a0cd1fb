// Barnes-Hut t-SNE gradient on the host: sklearn 1.9's space-partitioning
// tree (sklearn/neighbors/_quad_tree.pyx, a quadtree in 2-D and an octree
// in 3-D) and its gradient (sklearn/manifold/_barnes_hut_tsne.pyx), in the
// same float / double arithmetic, statement by statement, so that at one
// thread the forces are sklearn's. OpenMP splits the points statically, as
// Cython's prange does; the error and sum_Q are OpenMP reductions, so with
// more than one thread their sums are ordered differently.
//
// Plain C interface for ctypes:
//   float tsne_bh_gradient(const float* val_P, const float* pos,
//                          const int64_t* neighbors, const int64_t* indptr,
//                          int64_t n_samples, int32_t n_dimensions,
//                          float theta, int32_t dof, int32_t compute_error,
//                          int32_t num_threads, float* forces);
// num_threads ≤ 0 takes OpenMP's default team (sklearn's
// ``_openmp_effective_n_threads``). Returns the KL divergence (NaN unless
// compute_error), or -1 when the tree did not hold every point (sklearn
// asserts the same).
#include <omp.h>

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kEpsilon = 1e-6f;          // _quad_tree.pyx EPSILON
constexpr float kFloat32Tiny = FLT_MIN;    // np.finfo(np.float32).tiny
// _barnes_hut_tsne.pyx's FLOAT64_EPS is a ``cdef float``
const float kFloat64Eps = static_cast<float>(2.220446049250313e-16);

struct Cell {
  int64_t parent;
  int64_t children[8];
  int64_t cell_id;
  int64_t point_index;
  bool is_leaf;
  float squared_max_width;
  int64_t depth;
  int64_t cumulative_size;
  float center[3];
  float barycenter[3];
  float min_bounds[3];
  float max_bounds[3];
};

class Tree {
 public:
  explicit Tree(int n_dimensions)
      : nd_(n_dimensions), n_children_(1 << n_dimensions) {}

  void build(const float* X, int64_t n) {
    cells_.reserve(100);
    float m[3], M[3];
    for (int j = 0; j < nd_; ++j) {
      m[j] = X[j];
      M[j] = X[j];
    }
    for (int64_t i = 1; i < n; ++i) {
      for (int j = 0; j < nd_; ++j) {
        m[j] = std::min(m[j], X[i * nd_ + j]);
        M[j] = std::max(M[j], X[i * nd_ + j]);
      }
    }
    // np.maximum(M * (1. + 1e-3 * np.sign(M)), M + 1e-3) in float32
    const float k1e3 = 1e-3f;
    for (int j = 0; j < nd_; ++j) {
      const float sign = M[j] > 0.f ? 1.f : (M[j] < 0.f ? -1.f : 0.f);
      const float a = M[j] * (1.f + k1e3 * sign);
      const float b = M[j] + k1e3;
      M[j] = std::max(a, b);
    }
    init_root(m, M);
    float pt[3];
    for (int64_t i = 0; i < n; ++i) {
      for (int j = 0; j < nd_; ++j) pt[j] = X[i * nd_ + j];
      insert_point(pt, i, 0);
    }
  }

  int64_t root_size() const { return cells_[0].cumulative_size; }
  int64_t n_points() const { return n_points_; }

  // summarize(point, results, squared_theta): the tree's cells that stand
  // for ``point``, each as (dx.., squared distance, size)
  int64_t summarize(const float* point, float* results, float squared_theta,
                    int64_t cell_id, int64_t idx) const {
    const Cell& cell = cells_[cell_id];
    const int64_t idx_d = idx + nd_;
    bool duplicate = true;
    results[idx_d] = 0.f;
    for (int i = 0; i < nd_; ++i) {
      results[idx + i] = point[i] - cell.barycenter[i];
      results[idx_d] += results[idx + i] * results[idx + i];
      duplicate = duplicate && std::fabs(results[idx + i]) <= kEpsilon;
    }
    if (duplicate && cell.is_leaf) return idx;  // no self interaction
    if (cell.is_leaf ||
        (cell.squared_max_width / results[idx_d]) < squared_theta) {
      results[idx_d + 1] = static_cast<float>(cell.cumulative_size);
      return idx + nd_ + 2;
    }
    for (int c = 0; c < n_children_; ++c) {
      const int64_t child_id = cell.children[c];
      if (child_id != -1)
        idx = summarize(point, results, squared_theta, child_id, idx);
    }
    return idx;
  }

 private:
  void init_cell(Cell* cell, int64_t parent, int64_t depth) {
    cell->parent = parent;
    cell->is_leaf = true;
    cell->depth = depth;
    cell->squared_max_width = 0.f;
    cell->cumulative_size = 0;
    for (int i = 0; i < 8; ++i) cell->children[i] = -1;
  }

  void init_root(const float* min_bounds, const float* max_bounds) {
    cells_.emplace_back();
    Cell* root = &cells_[0];
    init_cell(root, -1, 0);
    for (int i = 0; i < nd_; ++i) {
      root->min_bounds[i] = min_bounds[i];
      root->max_bounds[i] = max_bounds[i];
      root->center[i] = static_cast<float>(
          (max_bounds[i] + min_bounds[i]) / 2.);
      const float width = max_bounds[i] - min_bounds[i];
      root->squared_max_width = std::max(root->squared_max_width,
                                         width * width);
    }
    root->cell_id = 0;
  }

  bool is_duplicate(const float* p1, const float* p2) const {
    bool res = true;
    for (int i = 0; i < nd_; ++i)
      res = res && std::fabs(p1[i] - p2[i]) <= kEpsilon;
    return res;
  }

  int64_t select_child(const float* point, const Cell& cell) const {
    int64_t selected = 0;
    for (int i = 0; i < nd_; ++i) {
      selected *= 2;
      if (point[i] >= cell.center[i]) selected += 1;
    }
    return cell.children[selected];
  }

  int64_t insert_in_new_child(const float* point_in, int64_t parent_id,
                              int64_t point_index, int64_t size) {
    float point[3];  // the point may lie in a cell that the growth moves
    for (int i = 0; i < nd_; ++i) point[i] = point_in[i];
    const int64_t cell_id = static_cast<int64_t>(cells_.size());
    cells_.emplace_back();
    Cell* cell = &cells_[parent_id];
    Cell* child = &cells_[cell_id];
    init_cell(child, cell->cell_id, cell->depth + 1);
    child->cell_id = cell_id;
    cell->is_leaf = false;
    cell->point_index = -1;
    int64_t cell_child_id = 0;
    for (int i = 0; i < nd_; ++i) {
      cell_child_id *= 2;
      if (point[i] >= cell->center[i]) {
        cell_child_id += 1;
        child->min_bounds[i] = cell->center[i];
        child->max_bounds[i] = cell->max_bounds[i];
      } else {
        child->min_bounds[i] = cell->min_bounds[i];
        child->max_bounds[i] = cell->center[i];
      }
      child->center[i] = static_cast<float>(
          (child->min_bounds[i] + child->max_bounds[i]) / 2.);
      const float width = child->max_bounds[i] - child->min_bounds[i];
      child->barycenter[i] = point[i];
      child->squared_max_width = std::max(child->squared_max_width,
                                          width * width);
    }
    child->point_index = point_index;
    child->cumulative_size = size;
    cell->children[cell_child_id] = child->cell_id;
    return cell_id;
  }

  int64_t insert_point(const float* point, int64_t point_index,
                       int64_t cell_id) {
    Cell* cell = &cells_[cell_id];
    const int64_t n_point = cell->cumulative_size;
    if (cell->cumulative_size == 0) {  // an empty leaf takes the point
      cell->cumulative_size = 1;
      n_points_ += 1;
      for (int i = 0; i < nd_; ++i) cell->barycenter[i] = point[i];
      cell->point_index = point_index;
      return cell_id;
    }
    if (!cell->is_leaf) {  // update the cell, then descend
      for (int ax = 0; ax < nd_; ++ax)
        cell->barycenter[ax] =
            (n_point * cell->barycenter[ax] + point[ax]) / (n_point + 1);
      cell->cumulative_size += 1;
      const int64_t selected = select_child(point, *cell);
      if (selected == -1) {
        n_points_ += 1;
        return insert_in_new_child(point, cell_id, point_index, 1);
      }
      return insert_point(point, point_index, selected);
    }
    if (is_duplicate(point, cell->barycenter)) {
      cell->cumulative_size += 1;
      n_points_ += 1;
      return cell_id;
    }
    // a leaf holding another point: move that point down, then retry
    float moved[3];
    for (int i = 0; i < nd_; ++i) moved[i] = cell->barycenter[i];
    insert_in_new_child(moved, cell_id, cell->point_index,
                        cell->cumulative_size);
    return insert_point(point, point_index, cell_id);
  }

  int nd_;
  int n_children_;
  int64_t n_points_ = 0;
  std::vector<Cell> cells_;
};

double gradient_negative(const float* pos, float* neg_f, const Tree& qt,
                         int64_t n, int nd, int dof, float theta,
                         int num_threads) {
  const int offset = nd + 2;
  const float exponent = (dof + 1.0) / 2.0;
  const float float_dof = static_cast<float>(dof);
  const float squared_theta = theta * theta;
  double sum_Q = 0.0;
#pragma omp parallel num_threads(num_threads) reduction(+ : sum_Q)
  {
    std::vector<float> summary(static_cast<size_t>(n) * offset);
    float point[3], neg_force[3];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      for (int ax = 0; ax < nd; ++ax) {
        neg_force[ax] = 0.f;
        point[ax] = pos[i * nd + ax];
      }
      const int64_t idx = qt.summarize(point, summary.data(), squared_theta,
                                       0, 0);
      for (int64_t j = 0; j < idx / offset; ++j) {
        const float dist2s = summary[j * offset + nd];
        const float size = summary[j * offset + nd + 1];
        double qijZ = float_dof / (float_dof + dist2s);
        if (dof != 1) qijZ = std::pow(qijZ, static_cast<double>(exponent));
        sum_Q += size * qijZ;
        const float mult = static_cast<float>(size * qijZ * qijZ);
        for (int ax = 0; ax < nd; ++ax)
          neg_force[ax] += mult * summary[j * offset + ax];
      }
      for (int ax = 0; ax < nd; ++ax) neg_f[i * nd + ax] = neg_force[ax];
    }
  }
  return std::max(sum_Q, static_cast<double>(kFloat64Eps));
}

float gradient_positive(const float* val_P, const float* pos,
                        const int64_t* neighbors, const int64_t* indptr,
                        float* pos_f, int64_t n, int nd, int dof,
                        double sum_Q, bool compute_error, int num_threads) {
  float C = 0.f;
  const float exponent = (dof + 1.0) / 2.0;
  const float float_dof = static_cast<float>(dof);
#pragma omp parallel num_threads(num_threads) reduction(+ : C)
  {
    float buff[3];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      for (int ax = 0; ax < nd; ++ax) pos_f[i * nd + ax] = 0.f;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        const int64_t j = neighbors[k];
        float dij = 0.f;
        const float pij = val_P[k];
        for (int ax = 0; ax < nd; ++ax) {
          buff[ax] = pos[i * nd + ax] - pos[j * nd + ax];
          dij += buff[ax] * buff[ax];
        }
        float qij = float_dof / (float_dof + dij);
        if (dof != 1) qij = powf(qij, exponent);
        dij = pij * qij;
        if (compute_error) {
          qij = static_cast<float>(qij / sum_Q);
          C += pij * ::log(static_cast<double>(
                          std::max(pij, kFloat32Tiny) /
                          std::max(qij, kFloat32Tiny)));
        }
        for (int ax = 0; ax < nd; ++ax) pos_f[i * nd + ax] += dij * buff[ax];
      }
    }
  }
  return C;
}

}  // namespace

extern "C" float tsne_bh_gradient(const float* val_P, const float* pos,
                                  const int64_t* neighbors,
                                  const int64_t* indptr, int64_t n_samples,
                                  int32_t n_dimensions, float theta,
                                  int32_t dof, int32_t compute_error,
                                  int32_t num_threads, float* forces) {
  const int nd = n_dimensions;
  if (num_threads <= 0) num_threads = omp_get_max_threads();
  Tree qt(nd);
  qt.build(pos, n_samples);
  std::vector<float> neg_f(static_cast<size_t>(n_samples) * nd);
  std::vector<float> pos_f(static_cast<size_t>(n_samples) * nd);
  const double sQ = gradient_negative(pos, neg_f.data(), qt, n_samples, nd,
                                      dof, theta, num_threads);
  float error = gradient_positive(val_P, pos, neighbors, indptr,
                                  pos_f.data(), n_samples, nd, dof, sQ,
                                  compute_error != 0, num_threads);
#pragma omp parallel for num_threads(num_threads) schedule(static)
  for (int64_t i = 0; i < n_samples; ++i)
    for (int ax = 0; ax < nd; ++ax) {
      const int64_t coord = i * nd + ax;
      forces[coord] = static_cast<float>(pos_f[coord] - (neg_f[coord] / sQ));
    }
  if (qt.root_size() != qt.n_points() || qt.n_points() != n_samples)
    return -1.f;
  return compute_error ? error : NAN;
}

// Host-side Clos/Benes routing of a static permutation.
//
// Factors out[j] = in[perm[j]] over E = R*C elements (an [R, C] row-major
// grid) into three row-local permutations around two block transposes:
//
//     out = P2_rows . T . P1_rows . T . P0_rows
//
// The demand multigraph between input rows and output rows is C-regular
// bipartite, hence C-edge-colourable (Konig); colour classes give the
// middle stage. The colouring is computed by recursive Euler splits (C a
// power of two): orienting an Eulerian circuit of a 2k-regular bipartite
// multigraph splits it into two k-regular halves. O(E log C), once per
// graph when the routed pack is built (ihgnn_torch/ops/packing.py).
//
// The port's own copy of the router of ihgnn_tpu (csrc/routing.cc,
// ihgnn_benes_route): the same algorithm visits edges in the same order,
// so both give the same tables for the same permutation. Its NumPy oracle
// is ihgnn_torch/ops/benes.py. Host code, built with g++ by
// ihgnn_torch/ops/native.py:
//
//   g++ -O2 -shared -fPIC -std=c++17 -o routing.so routing.cc

#include <cstdint>
#include <vector>

namespace {

// Split a bipartite multigraph with all-even degrees into two halves with
// equal per-vertex degree. Edges traversed left->right on the Eulerian
// circuits go to half A (mask = 1).
void euler_split(const int32_t* u, const int32_t* v, int64_t e_count,
                 int32_t n_left, int32_t n_right, uint8_t* mask) {
  std::vector<int64_t> lptr(n_left + 1, 0), rptr(n_right + 1, 0);
  for (int64_t e = 0; e < e_count; ++e) {
    ++lptr[u[e] + 1];
    ++rptr[v[e] + 1];
  }
  for (int32_t i = 0; i < n_left; ++i) lptr[i + 1] += lptr[i];
  for (int32_t i = 0; i < n_right; ++i) rptr[i + 1] += rptr[i];
  std::vector<int64_t> ledges(e_count), redges(e_count);
  {
    std::vector<int64_t> lfill(lptr.begin(), lptr.end() - 1);
    std::vector<int64_t> rfill(rptr.begin(), rptr.end() - 1);
    for (int64_t e = 0; e < e_count; ++e) {
      ledges[lfill[u[e]]++] = e;
      redges[rfill[v[e]]++] = e;
    }
  }
  std::vector<int64_t> lcur(lptr.begin(), lptr.end() - 1);
  std::vector<int64_t> rcur(rptr.begin(), rptr.end() - 1);
  std::vector<uint8_t> used(e_count, 0);

  auto next_unused = [&](int32_t vertex, bool on_left) -> int64_t {
    if (on_left) {
      while (lcur[vertex] < lptr[vertex + 1]) {
        int64_t e = ledges[lcur[vertex]++];
        if (!used[e]) return e;
      }
    } else {
      while (rcur[vertex] < rptr[vertex + 1]) {
        int64_t e = redges[rcur[vertex]++];
        if (!used[e]) return e;
      }
    }
    return -1;
  };

  for (int64_t start = 0; start < e_count; ++start) {
    if (used[start]) continue;
    int64_t e = start;
    bool at_left = true;  // traversing e from u[e] (left) to v[e] (right)
    while (e != -1 && !used[e]) {
      used[e] = 1;
      mask[e] = at_left ? 1 : 0;
      int32_t vertex = at_left ? v[e] : u[e];
      at_left = !at_left;
      e = next_unused(vertex, at_left);
    }
  }
}

// Colour a `degree`-regular bipartite multigraph (power-of-two degree)
// with `degree` colours; at every vertex each colour appears once.
void color_recurse(const int32_t* u, const int32_t* v, int32_t n_vertices,
                   std::vector<int64_t>& edge_ids, int32_t degree,
                   int32_t base, int32_t* colors) {
  if (degree == 1) {
    for (int64_t e : edge_ids) colors[e] = base;
    return;
  }
  int64_t m = static_cast<int64_t>(edge_ids.size());
  std::vector<int32_t> su(m), sv(m);
  for (int64_t i = 0; i < m; ++i) {
    su[i] = u[edge_ids[i]];
    sv[i] = v[edge_ids[i]];
  }
  std::vector<uint8_t> mask(m);
  euler_split(su.data(), sv.data(), m, n_vertices, n_vertices, mask.data());
  std::vector<int64_t> half_a, half_b;
  half_a.reserve(m / 2);
  half_b.reserve(m / 2);
  for (int64_t i = 0; i < m; ++i) {
    (mask[i] ? half_a : half_b).push_back(edge_ids[i]);
  }
  std::vector<int64_t>().swap(edge_ids);  // free before recursing
  color_recurse(u, v, n_vertices, half_a, degree / 2, base, colors);
  color_recurse(u, v, n_vertices, half_b, degree / 2, base + degree / 2,
                colors);
}

}  // namespace

extern "C" {

// Factor out[j] = in[perm[j]] (E = rows*cols) into three row-local stages:
//   p0: [rows, cols]   a0[r, c] = in[r, p0[r, c]]
//   T                  t0[c, r] = a0[r, c]
//   p1: [cols, rows]   a1[c, r] = t0[c, p1[c, r]]
//   T                  t1[r, c] = a1[c, r]
//   p2: [rows, cols]   out[r, c] = t1[r, p2[r, c]]
// cols must be a power of two. Returns 0, or 1 (E != rows*cols), 2 (cols
// not a power of two), 3 (an entry of perm out of range).
int ihgnn_benes_route(const int64_t* perm, int64_t e_count, int32_t rows,
                      int32_t cols, int32_t* p0, int32_t* p1, int32_t* p2) {
  if (static_cast<int64_t>(rows) * cols != e_count) return 1;
  if (cols <= 0 || (cols & (cols - 1)) != 0) return 2;
  std::vector<int32_t> in_row(e_count), out_row(e_count), in_col(e_count);
  for (int64_t j = 0; j < e_count; ++j) {
    int64_t src = perm[j];
    if (src < 0 || src >= e_count) return 3;
    in_row[j] = static_cast<int32_t>(src / cols);
    in_col[j] = static_cast<int32_t>(src % cols);
    out_row[j] = static_cast<int32_t>(j / cols);
  }
  std::vector<int32_t> color(e_count);
  {
    std::vector<int64_t> all(e_count);
    for (int64_t e = 0; e < e_count; ++e) all[e] = e;
    color_recurse(in_row.data(), out_row.data(), rows, all, cols, 0,
                  color.data());
  }
  // stage 0: within input row r, the colour-k element moves to column k;
  // stage 1: within colour row k, the element bound for output row r_out
  // moves to column r_out; stage 2: output (r_out, c_out) takes its
  // element from colour column k
  for (int64_t j = 0; j < e_count; ++j) {
    int64_t c_out = j % cols;
    p0[static_cast<int64_t>(in_row[j]) * cols + color[j]] = in_col[j];
    p1[static_cast<int64_t>(color[j]) * rows + out_row[j]] = in_row[j];
    p2[static_cast<int64_t>(out_row[j]) * cols + c_out] = color[j];
  }
  return 0;
}

}  // extern "C"

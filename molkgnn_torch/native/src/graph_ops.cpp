// Native graph ops of molkgnn_torch (host side, C ABI for ctypes).
//
// A copy of molkgnn_tpu/native/src/graph_ops.cpp.
//
// 1) floyd_warshall / gen_edge_input: all-pairs shortest paths with the
//    510 "unreachable" sentinel and edge-feature sequences along shortest
//    paths, as the reference MolKGNN implementation's Cython module
//    (LanceKnight/MolKGNN, algos.pyx) computes them. No model uses them;
//    the Python module exposes them as utilities under
//    molkgnn_torch.native.
//
// 2) ranges_gather_*: expand per-graph [start, start+len) ranges and gather
//    rows, with an optional per-range offset (index relocation).
//
// Built by molkgnn_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC graph_ops.cpp -o libgraph_ops_<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// All-pairs shortest path on a dense adjacency matrix.
// adj: [n*n] int64 (1 = edge, 0 = none, diagonal ignored)
// out_dist: [n*n] int64 distances (510 where unreachable)
// out_pred: [n*n] int64 intermediate-vertex matrix for path reconstruction
void floyd_warshall(const int64_t* adj, int64_t n, int64_t* out_dist,
                    int64_t* out_pred) {
  const int64_t kUnreach = 510;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      int64_t idx = i * n + j;
      if (i == j) {
        out_dist[idx] = 0;
      } else if (adj[idx]) {
        out_dist[idx] = 1;
      } else {
        out_dist[idx] = kUnreach;
      }
      out_pred[idx] = -1;  // direct edge / unreachable
    }
  }
  for (int64_t k = 0; k < n; ++k) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t dik = out_dist[i * n + k];
      if (dik >= kUnreach) continue;
      for (int64_t j = 0; j < n; ++j) {
        int64_t cand = dik + out_dist[k * n + j];
        if (cand < out_dist[i * n + j]) {
          out_dist[i * n + j] = cand;
          out_pred[i * n + j] = k;
        }
      }
    }
  }
}

// Reconstruct the shortest path from i to j (inclusive) using the pred
// matrix. Returns path length (#vertices) or 0 if unreachable.
static int64_t get_path(const int64_t* pred, int64_t n, int64_t i, int64_t j,
                        int64_t* out, int64_t cap) {
  int64_t k = pred[i * n + j];
  if (k < 0) {  // direct edge (or unreachable — caller checks dist)
    if (cap < 2) return 0;
    out[0] = i;
    out[1] = j;
    return 2;
  }
  int64_t left = get_path(pred, n, i, k, out, cap);
  if (left == 0) return 0;
  int64_t right =
      get_path(pred, n, k, j, out + left - 1, cap - left + 1);
  if (right == 0) return 0;
  return left + right - 1;
}

// Edge-feature sequences along all-pairs shortest paths
// (the reference's gen_edge_input, algos.pyx).
// edge_feat: [n*n*fdim] float32 (features of direct edges, 0 elsewhere)
// out: [n*n*max_dist*fdim] float32
void gen_edge_input(const int64_t* dist, const int64_t* pred,
                    const float* edge_feat, int64_t n, int64_t fdim,
                    int64_t max_dist, float* out) {
  std::vector<int64_t> path(n + 1);
  std::memset(out, 0,
              sizeof(float) * (size_t)n * n * max_dist * fdim);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      if (i == j) continue;
      if (dist[i * n + j] >= 510) continue;
      int64_t len = get_path(pred, n, i, j, path.data(), n + 1);
      if (len == 0) continue;
      int64_t hops = len - 1;
      if (hops > max_dist) hops = max_dist;
      for (int64_t h = 0; h < hops; ++h) {
        const float* src =
            edge_feat + ((path[h] * n + path[h + 1]) * fdim);
        float* dst = out + (((i * n + j) * max_dist + h) * fdim);
        std::memcpy(dst, src, sizeof(float) * (size_t)fdim);
      }
    }
  }
}

// Expand ranges and gather float32 rows:
// out[k] = src[starts[g(k)] + within(k)] for the concatenation of ranges.
void ranges_gather_f32(const float* src, int64_t row_dim,
                       const int64_t* starts, const int64_t* lens,
                       int64_t num_ranges, float* out) {
  float* dst = out;
  for (int64_t r = 0; r < num_ranges; ++r) {
    const float* s = src + starts[r] * row_dim;
    std::memcpy(dst, s, sizeof(float) * (size_t)lens[r] * row_dim);
    dst += lens[r] * row_dim;
  }
}

// Same for int32 rows with a per-range additive offset (index relocation).
void ranges_gather_offset_i32(const int32_t* src, int64_t row_dim,
                              const int64_t* starts, const int64_t* lens,
                              const int32_t* offsets, int64_t num_ranges,
                              int32_t* out) {
  int32_t* dst = out;
  for (int64_t r = 0; r < num_ranges; ++r) {
    const int32_t* s = src + starts[r] * row_dim;
    int64_t cnt = lens[r] * row_dim;
    int32_t off = offsets[r];
    for (int64_t k = 0; k < cnt; ++k) dst[k] = s[k] + off;
    dst += cnt;
  }
}

}  // extern "C"

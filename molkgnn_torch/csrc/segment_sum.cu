// Fixed-order CSR segment sum for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. It replaces the float atomics of CUDA
// index_add_, which the port's segment sums, message passing, pooling and
// the gradients of its gathers would otherwise use, and whose order, and so
// the last bits of a sum of two or more terms, changes from run to run. The
// JAX package sums with XLA's segment_sum (molkgnn_tpu/ops/segment.py),
// in a fixed order; this kernel gives the port that property back.
//
// For every segment s < num_segments and column c < f:
//   out[s, c] = sum_{i = rowptr[s]}^{rowptr[s+1]-1} values[row[i], c]
// summed from +0 in ascending i with plain IEEE adds (__fadd_rn /
// __dadd_rn: no FMA contraction, no reassociation). values [R, f] and out
// [num_segments, f] are row-major fp32 or fp64; row and rowptr are int32.
//
// Its order is the plain version's. The plan (csrc/segment_plan.cu, or
// the plain torch chain of ops/segment.py) is a stable sort of the segment
// ids, so a segment's terms keep their order in the list, and the plain
// version (CPU index_add_, like np.add.at) adds the terms of each output in
// list order, starting from zero. The two sums are then the same sequence
// of roundings: bit-equal. Masked terms lie in one more segment
// (num_segments) that the kernel does not compute; the plain version adds a
// zero for them, which changes no sum that starts from +0.
//
// What bounds it on this card: bytes. It does one add per term and column
// against the terms' gathered rows (each distinct row read once from
// memory at the least), num_segments * f values written and the indices
// (E + num_segments + 1 int32): far below the ridge point of any unit. It
// is a gather with no product, so Hopper's tensor-core paths (wgmma, TMA,
// clusters) have nothing to do here. What the design does about the bytes
// and the latency of a dependent gather:
//
//   * A group of G lanes per (segment, column tile), G a power of two up
//     to 32: the lanes cover the row's columns in vector units (V columns:
//     float4 or double2 where the row pitch and the base pointers allow 16
//     bytes, float2 where they allow 8, else one), CPL vector columns a
//     lane (G = 32 only, and only where the segments alone fill the card),
//     so a term's row is read by neighbouring lanes at neighbouring
//     addresses. Where a row is narrow several segments share
//     a warp: f = 32 in fp32 is 8 float4 lanes, 4 segments a warp; the
//     [N] sums (f = 1) are a lane per segment. Rows wider than G * CPL
//     vectors are cut into column tiles, each its own group. The host
//     (ops/segment.py::sum_launch) picks V, G, CPL and the tiles: V divides
//     f, so no row has a ragged tail.
//   * The segment's row ids are loaded once a group, coalesced (C ids a
//     chunk, C / G a lane), and broadcast to the group's lanes with
//     __shfl_sync: a column never re-reads them.
//   * Loads issued ahead, adds in order: a lane issues the loads of the next
//     4 / CPL terms (4 vectors) before it adds them; the loads are
//     independent, the adds stay in ascending term order. (16 in flight
//     ran slower at the flagship's shapes.)
//   * 32-bit index arithmetic where R * f, num_segments * f and the thread
//     count fit an int32 (the host checks); otherwise a 64-bit instance
//     (G = 32, CPL = 1).
//   * A grid sized to the groups, with no cap; an empty segment writes its
//     zeros and walks nothing.
//   * No atomics and no reduction across lanes: either would change the
//     order.
//
// Left for later: a segment with very many terms (the gradient of an
// embedding table gathered by atom type) is walked by one group; cutting
// it into chunks would change the order of its adds, and needs a second,
// ordered pass to keep it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // small blocks spread a small grid over the SMs
constexpr int kDepth = 4;       // vector loads in flight a lane

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 1> {
  using type = float;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 1> {
  using type = double;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ double vadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

// One group of G lanes per (segment, column tile); ``tiles`` column tiles
// a segment, each G * CPL vectors wide; fv vectors a row.
template <typename T, int V, int G, int CPL, typename Idx>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const typename Vec<T, V>::type* __restrict__ values,
                       const int* __restrict__ row,
                       const int* __restrict__ rowptr,
                       typename Vec<T, V>::type* __restrict__ out,
                       Idx num_groups, int tiles, int fv) {
  using VT = typename Vec<T, V>::type;
  constexpr int U = kDepth / CPL;  // terms whose loads fly at once
  constexpr int C = G > U ? G : U;  // row ids a chunk
  constexpr int K = C / G;          // row ids a lane holds
  const Idx group = (static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x) /
                    G;
  if (group >= num_groups) return;  // a group's lanes leave together
  const int lane = threadIdx.x & (G - 1);
  const unsigned peers =
      G == 32 ? 0xffffffffu
              : ((1u << (G & 31)) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const Idx seg = group / tiles;
  const int col0 =
      static_cast<int>(group - seg * tiles) * (G * CPL) + lane;
  const int begin = __ldg(rowptr + seg);
  const int end = __ldg(rowptr + seg + 1);

  // A term past the segment's end loads nothing and adds +0, which leaves
  // every sum as it is (a sum from +0 is never -0), so the loop needs no
  // branch around its shuffles and adds.
  VT acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = VT{};
  for (int i = begin; i < end; i += C) {
    const int n = min(C, end - i);  // the same on every lane of the group
    int ids[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = k * G + lane;
      ids[k] = t < n ? __ldg(row + i + t) : 0;
    }
#pragma unroll
    for (int t0 = 0; t0 < C; t0 += U) {
      if (t0 >= n) break;
      VT v[U][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u;
        int r;
        if constexpr (G == 1) {
          r = ids[t];
        } else {
          r = __shfl_sync(peers, ids[t / G], t % G, G);
        }
        const VT* src = values + static_cast<Idx>(r) * fv;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = col0 + k * G;
          v[u][k] = t < n && c < fv ? __ldg(src + c) : VT{};
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] = vadd(acc[k], v[u][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = col0 + k * G;
    if (c < fv) out[seg * fv + c] = acc[k];
  }
}

template <typename T, int V, int G, int CPL, typename Idx>
int launch(const void* values, const int* row, const int* rowptr, void* out,
           int64_t num_groups, int tiles, int fv, cudaStream_t stream) {
  using VT = typename Vec<T, V>::type;
  const int64_t blocks = (num_groups * G + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return -1;
  segment_sum_kernel<T, V, G, CPL, Idx>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const VT*>(values), row, rowptr, static_cast<VT*>(out),
          static_cast<Idx>(num_groups), tiles, fv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_vec(int group, int cpl, int wide, const void* values,
               const int* row, const int* rowptr, void* out,
               int64_t num_groups, int tiles, int fv, cudaStream_t s) {
#define MOLKGNN_SEGMENT_CASE(G_, CPL_, WIDE_, IDX_)                          \
  if (group == G_ && cpl == CPL_ && wide == WIDE_) {                         \
    return launch<T, V, G_, CPL_, IDX_>(values, row, rowptr, out,            \
                                        num_groups, tiles, fv, s);           \
  }
  MOLKGNN_SEGMENT_CASE(1, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(2, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(4, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(8, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(16, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(32, 1, 0, int)
  MOLKGNN_SEGMENT_CASE(32, 2, 0, int)
  MOLKGNN_SEGMENT_CASE(32, 4, 0, int)
  MOLKGNN_SEGMENT_CASE(32, 1, 1, int64_t)
#undef MOLKGNN_SEGMENT_CASE
  return -1;
}

}  // namespace

extern "C" {

// out [num_segments, f] = the segment sums of values [*, f] over the plan
// (row, rowptr [num_segments + 1 or more]), on `stream`, launched as the
// host chose: `vec` columns a vector (V), `group` lanes a group (G), `cpl`
// vectors a lane, `tiles` column tiles a segment, `wide` for 64-bit
// indices. dtype 0 is fp32, 1 is fp64. Returns 0, a cudaError_t, or -1 for
// arguments the kernel does not take.
int molkgnn_segment_sum(int dtype, int vec, int group, int cpl, int tiles,
                        int wide, const void* values,
                        const int* row, const int* rowptr, void* out,
                        int64_t num_segments, int64_t f, void* stream) {
  if (num_segments < 0 || f <= 0 || vec <= 0 || f % vec != 0 || tiles <= 0)
    return -1;
  const int64_t fv = f / vec;
  if (fv > INT_MAX || static_cast<int64_t>(tiles) * group * cpl < fv)
    return -1;
  if (num_segments == 0) return 0;
  const int64_t n = num_segments * tiles;
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(fv);
  if (dtype == 0 && vec == 1)
    return launch_vec<float, 1>(group, cpl, wide, values, row, rowptr,
                                out, n, tiles, v, s);
  if (dtype == 0 && vec == 2)
    return launch_vec<float, 2>(group, cpl, wide, values, row, rowptr,
                                out, n, tiles, v, s);
  if (dtype == 0 && vec == 4)
    return launch_vec<float, 4>(group, cpl, wide, values, row, rowptr,
                                out, n, tiles, v, s);
  if (dtype == 1 && vec == 1)
    return launch_vec<double, 1>(group, cpl, wide, values, row,
                                 rowptr, out, n, tiles, v, s);
  if (dtype == 1 && vec == 2)
    return launch_vec<double, 2>(group, cpl, wide, values, row,
                                 rowptr, out, n, tiles, v, s);
  return -1;
}

const char* molkgnn_segment_sum_error_string(int code) {
  if (code == -1) return "invalid arguments for the segment sum";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

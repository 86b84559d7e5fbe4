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
// Its order is the plain version's. ops/segment.py builds the plan with a
// stable sort of the segment ids, so a segment's terms keep their order in
// the list, and its plain version (CPU index_add_, like np.add.at) adds the
// terms of each output in list order, starting from zero. The two sums are
// then the same sequence of roundings: bit-equal. Masked terms lie in one
// more segment (num_segments) that the kernel does not compute; the plain
// version adds a zero for them, which changes no sum that starts from +0.
//
// What bounds it on this card: bytes. It does one add per term and column
// against the E terms' gathered rows (each distinct row read once from
// memory at the least: a row that several terms gather can come from L2),
// num_segments * f values written and the indices (E + num_segments + 1
// int32): far below the ridge point of any unit, so the bound is the
// memory rate. The design, right and simple
// first:
//
//   * One thread per output element (s, c), c fastest, over a flat index:
//     the threads of a warp read neighbouring columns of one gathered row,
//     coalesced, and where f is small (the [N] sums, f = 1) the same flat
//     index puts neighbouring segments on neighbouring lanes, so no lane
//     idles.
//   * No atomics and no reduction across threads: either would change the
//     order. A thread walks its segment's terms itself; the loads of a few
//     terms are issued ahead (unrolled), the adds stay in order.
//   * A grid-stride loop over the outputs; indices in 64 bits.
//
// Left for later: a segment with very many terms (the gradient of an
// embedding table gathered by atom type) is walked by one thread per
// column; splitting it would need a second, ordered pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // SMs x resident blocks, grid-stride

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ values,
                       const int* __restrict__ row,
                       const int* __restrict__ rowptr, T* __restrict__ out,
                       int64_t num_segments, int64_t f) {
  const int64_t total = num_segments * f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t s = t / f;
    const int64_t c = t - s * f;
    const int begin = rowptr[s];
    const int end = rowptr[s + 1];
    T acc = T(0);
#pragma unroll 4
    for (int i = begin; i < end; ++i) {
      acc = add_rn(acc, values[static_cast<int64_t>(row[i]) * f + c]);
    }
    out[t] = acc;
  }
}

template <typename T>
int launch(const void* values, const int* row, const int* rowptr, void* out,
           int64_t num_segments, int64_t f, cudaStream_t stream) {
  const int64_t total = num_segments * f;
  if (total == 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_sum_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(values), row, rowptr, static_cast<T*>(out),
      num_segments, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [num_segments, f] = the segment sums of values [*, f] over the plan
// (row, rowptr [num_segments + 1 or more]), on `stream`. dtype 0 is fp32,
// 1 is fp64. Returns 0, a cudaError_t, or -1 for arguments the kernel does
// not take.
int molkgnn_segment_sum(int dtype, const void* values, const int* row,
                        const int* rowptr, void* out, int64_t num_segments,
                        int64_t f, void* stream) {
  if (num_segments < 0 || f < 0) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(values, row, rowptr, out, num_segments, f, s);
  }
  if (dtype == 1) {
    return launch<double>(values, row, rowptr, out, num_segments, f, s);
  }
  return -1;
}

const char* molkgnn_segment_sum_error_string(int code) {
  if (code == -1) return "invalid arguments for the segment sum";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

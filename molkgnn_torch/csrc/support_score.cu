// Permutation-max support scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of molkgnn_tpu/ops/pallas_kernels.py:
// _score_kernel behind _fused_support_score (one bucket) and
// _grouped_kernel behind _grouped_impl (all degree buckets of a layer in
// one launch). One entry point serves both: the fused call is G = 1.
//
// For every group g, row m and kernel l:
//   best[m, l] = max_p  sum_k a[m, k] * b[p, k, l]
//   idx[m, l]  = the first p reaching that max (strict '>', as the TPU
//                kernels and torch.max), int32.
// a [M, K], b [P, K, L], best [M, L] are fp32 and row-major; accumulation
// is fp32, k ascending.
//
// Design (simple and correct first). The TPU kernels keep all of B resident
// in VMEM (about 1 MB at deg 4, K = 440, L = 50, P = 12); an SM has 227 KB
// of shared memory, so here only A is staged on chip:
//   * a block owns a tile of TM rows x TL columns of one group, with
//     TM * TL = 1024 outputs and TL the power of two in {16, 32, 64} that
//     fits L best, so that narrow groups (L = 10) do not idle threads;
//   * the block stages A[m0:m0+TM, k0:k0+64] in shared memory, one K chunk
//     at a time, zero-padding the ragged edges (no 128-padding in memory);
//   * B is read from global memory, where one group's B stays in the 50 MB
//     L2; neighbouring threads read neighbouring l, so the loads coalesce;
//   * each thread holds 4 outputs of one column and up to 12 permutation
//     accumulators per output in registers, then reduces over p in order.
// Per-group pointers, sizes and P travel in a __grid_constant__ table, so
// nothing is padded or copied before the launch.
//
// What bounds it on this card: at the flagship shapes the work is about
// 2 * M * K * L * P fp32 operations against (M*K + P*K*L) * 4 + M*L*8
// bytes, far above the card's fp32 ridge point, so the bound is the fp32
// rate of the CUDA cores (67 TFLOP/s). This kernel issues one B load per
// four FMAs and is limited by its loads well below that; moving the product
// onto the tensor cores (wgmma, with TMA-fed shared-memory tiles of B) is
// the work of later versions.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 4;
constexpr int kTileOutputs = kThreads * kOutPerThread;  // TM * TL
constexpr int kMinTileLog2 = 4;                         // TL >= 16
constexpr int kMaxTileRows = kTileOutputs >> kMinTileLog2;  // 64
constexpr int kChunkK = 64;      // K columns of A staged per step
constexpr int kChunkP = 12;      // permutations accumulated per pass
constexpr int kMaxGroups = 16;

struct Group {
  const float* a;
  const float* b;
  float* best;
  int* idx;
  int m, k, l, p;
  int tl_log2;     // log2 of the tile width TL
  int l_tiles;     // ceil(l / TL)
  int tile_begin;  // first block of this group
};

struct GroupTable {
  int count;
  Group g[kMaxGroups];
};

__global__ void __launch_bounds__(kThreads)
support_score_kernel(const __grid_constant__ GroupTable table) {
  // +1 column: rows read by one warp fall in different banks.
  __shared__ float a_s[kMaxTileRows][kChunkK + 1];

  int gi = 0;
  while (gi + 1 < table.count &&
         static_cast<int>(blockIdx.x) >= table.g[gi + 1].tile_begin) {
    ++gi;
  }
  const Group& g = table.g[gi];
  const int local = blockIdx.x - g.tile_begin;
  const int tl_log2 = g.tl_log2;
  const int tile_rows = kTileOutputs >> tl_log2;
  const int m0 = (local / g.l_tiles) * tile_rows;
  const int col = threadIdx.x & ((1 << tl_log2) - 1);
  const int l = (local % g.l_tiles) * (1 << tl_log2) + col;
  const bool l_ok = l < g.l;
  const int row0 = threadIdx.x >> tl_log2;      // tile row of output 0
  const int row_step = kThreads >> tl_log2;     // rows between outputs
  const size_t kl = static_cast<size_t>(g.k) * g.l;

  float best[kOutPerThread];
  int arg[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    best[j] = 0.f;
    arg[j] = 0;
  }

  for (int p0 = 0; p0 < g.p; p0 += kChunkP) {
    const int pc = min(kChunkP, g.p - p0);
    float acc[kChunkP][kOutPerThread];
#pragma unroll
    for (int q = 0; q < kChunkP; ++q) {
#pragma unroll
      for (int j = 0; j < kOutPerThread; ++j) acc[q][j] = 0.f;
    }

    for (int k0 = 0; k0 < g.k; k0 += kChunkK) {
      const int kc = min(kChunkK, g.k - k0);
      __syncthreads();  // the previous chunk has been read
      for (int i = threadIdx.x; i < tile_rows * kChunkK; i += kThreads) {
        const int r = i / kChunkK;
        const int c = i % kChunkK;
        const int m = m0 + r;
        a_s[r][c] = (m < g.m && c < kc)
                        ? g.a[static_cast<size_t>(m) * g.k + k0 + c]
                        : 0.f;
      }
      __syncthreads();
      if (l_ok) {
        const float* bp = g.b + p0 * kl + static_cast<size_t>(k0) * g.l + l;
        for (int c = 0; c < kc; ++c) {
          float av[kOutPerThread];
#pragma unroll
          for (int j = 0; j < kOutPerThread; ++j) {
            av[j] = a_s[row0 + j * row_step][c];
          }
#pragma unroll
          for (int q = 0; q < kChunkP; ++q) {
            if (q < pc) {
              const float bv = __ldg(bp + q * kl + static_cast<size_t>(c) * g.l);
#pragma unroll
              for (int j = 0; j < kOutPerThread; ++j) {
                acc[q][j] = fmaf(av[j], bv, acc[q][j]);
              }
            }
          }
        }
      }
    }

    // Reduce over this pass's permutations in order; strict '>' keeps the
    // first max.
#pragma unroll
    for (int q = 0; q < kChunkP; ++q) {
      if (q < pc) {
#pragma unroll
        for (int j = 0; j < kOutPerThread; ++j) {
          if (p0 + q == 0 || acc[q][j] > best[j]) {
            best[j] = acc[q][j];
            arg[j] = p0 + q;
          }
        }
      }
    }
  }

  if (l_ok) {
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int m = m0 + row0 + j * row_step;
      if (m < g.m) {
        const size_t o = static_cast<size_t>(m) * g.l + l;
        g.best[o] = best[j];
        g.idx[o] = arg[j];
      }
    }
  }
}

int tile_log2_for(int l) {
  if (l <= 16) return 4;
  if (l <= 32) return 5;
  return 6;
}

}  // namespace

extern "C" {

// Launches the scorer over `num_groups` groups on `stream`. The pointer
// arrays hold device addresses; the size arrays are host memory. Returns 0,
// a cudaError_t from the launch, or -1 for arguments the kernel does not
// take (too many groups, P < 1, negative sizes).
int molkgnn_support_score(int num_groups, const uint64_t* a_ptrs,
                          const uint64_t* b_ptrs, const uint64_t* best_ptrs,
                          const uint64_t* idx_ptrs, const int* m,
                          const int* k, const int* l, const int* p,
                          void* stream) {
  if (num_groups < 1 || num_groups > kMaxGroups) return -1;
  GroupTable table;
  table.count = num_groups;
  int tiles = 0;
  for (int i = 0; i < num_groups; ++i) {
    if (m[i] < 0 || k[i] < 0 || l[i] < 0 || p[i] < 1) return -1;
    Group& g = table.g[i];
    g.a = reinterpret_cast<const float*>(a_ptrs[i]);
    g.b = reinterpret_cast<const float*>(b_ptrs[i]);
    g.best = reinterpret_cast<float*>(best_ptrs[i]);
    g.idx = reinterpret_cast<int*>(idx_ptrs[i]);
    g.m = m[i];
    g.k = k[i];
    g.l = l[i];
    g.p = p[i];
    g.tl_log2 = tile_log2_for(l[i]);
    const int tl = 1 << g.tl_log2;
    const int rows = kTileOutputs >> g.tl_log2;
    g.l_tiles = (l[i] + tl - 1) / tl;
    g.tile_begin = tiles;
    tiles += ((m[i] + rows - 1) / rows) * g.l_tiles;
  }
  if (tiles == 0) return 0;
  support_score_kernel<<<tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

const char* molkgnn_error_string(int code) {
  if (code == -1) return "invalid arguments for the support scorer";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

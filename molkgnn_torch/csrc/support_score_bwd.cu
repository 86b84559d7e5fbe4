// Backward of the permutation-max support scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the backward halves of the JAX package's two custom VJPs around
// its Pallas scorers, molkgnn_tpu/ops/pallas_kernels.py: _fss_bwd (line 76,
// behind _fused_support_score_vjp) and _grouped_bwd (line 251, behind
// _grouped_vjp). One entry point serves both: the fused call is G = 1.
//
// For every group, with a [M, K], b [P, K, L], the output gradient
// g [M, L] and the forward's argmax idx [M, L] (int32):
//   da[m, k]    = sum_l g[m, l] * b[idx[m, l], k, l]           (l ascending)
//   db[p, k, l] = sum_m [idx[m, l] == p] * a[m, k] * g[m, l]   (m ascending)
// The gradient flows only through the chosen permutation, as in the JAX
// VJPs; no [M, P, L] tensor is made and no product runs over the P - 1
// permutations that were not chosen. fp32, fmaf, no atomics: every term
// is added by one thread in a fixed order (db's over ranges of rows, then
// the ranges' sums in range order), so a call repeats bit for bit and does
// not depend on the order of blocks.
//
// What bounds it on this card. Each term is one FMA, M*K*L of them for da
// and as many for db, against reading a, g, idx and b once and writing da
// and db once: 2 operations an FMA, about 12 operations a byte at the
// flagship's N-hop shapes, below the fp32 ridge point (67 TFLOP/s over
// 3.35 TB/s, 20 a byte). So the bound is the bytes. What holds a kernel of
// this shape above it is that the b (for da) or the slot (for db) that a
// term needs is picked by idx per (m, l): no register holds it for more
// than one term, so every FMA reads shared memory once (at most 32 FMAs a
// clock on an SM, against 128 for the fp32 cores). The design:
//
//   * da (score_grad_da_kernel). A block owns 32 columns k of a group and
//     a range of rows. It stages b[:, k0:k0+32, :] for every p and l in
//     shared memory once ([P][L][32] floats, 77 KB at P = 12, L = 50; each
//     row's 16-byte chunks swizzled by l against bank conflicts), then
//     walks its rows a tile at a time: the tile's g and idx land as
//     (g, idx) pairs by cp.async, the next tile's copies in flight while
//     this one is summed, and a tile is taller where L is small, so that
//     it has work enough to cover them. Eight lanes share a row, each
//     adding g * b[idx, k:k+4, l] over l in ascending order into 4
//     registers, four l's of 16-byte loads in flight. Where [P][L][32]
//     does not fit (96 KB), the lanes read b from device memory instead
//     (any P and L).
//   * db (score_grad_db_kernel). A block owns 128 columns k (4 a lane), up
//     to 8 kernels l (one a warp) and a fixed range of rows, staged 64 rows
//     at a time by cp.async in two stages. For 32 rows at once a warp
//     ballots which rows chose permutation p at its l, then adds
//     g * a[m, k:k+4] over those rows in ascending m into 4 registers of
//     slot p. The slots are a template on PC = 1, 2, 6 and 12 permutations
//     (the flagship's P), with passes of PC for any other P, as in the
//     forward. Each block writes its range's partial sums to scratch.
//   * db_sum (score_grad_db_sum_kernel) adds the ranges' partial sums in
//     range order into db [P, K, L]. Ranges are set on the host so that a
//     group has about 256 blocks.
//
// The three kernels go on the caller's stream one after another and never
// synchronise with the host, so a CUDA graph captures them.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;
constexpr int kTargetBlocks = 256;  // blocks a group, roughly, per kernel

// da: a block's columns (8 lanes a row, 4 columns a lane), rows a step (4
// a warp), l's of g and idx staged at a time at most, and the shared
// memory that staged B may take. A tile takes 64 / min(L, 64) steps of
// rows, so that a tile of small L still has work enough to cover the next
// tile's copies; a stage then holds at most kDaRows * 96 pairs (L = 2).
constexpr int kDaK = 32;
constexpr int kDaRows = 32;
constexpr int kDaLChunk = 64;
constexpr int kDaBBudget = 96 * 1024;
constexpr int kDaMaxSmem = 2 * kDaRows * 96 * 8 + kDaBBudget;

// db: a block's columns (4 a lane), l's (one a warp), rows a chunk, and the
// floats of one stage: a [kDbRows][kDbK], g and idx [kDbL][kDbRows].
constexpr int kDbK = 128;
constexpr int kDbL = kWarps;
constexpr int kDbRows = 64;
constexpr int kDbStage = kDbRows * kDbK + 2 * kDbL * kDbRows;
constexpr int kDbSmem = 2 * kDbStage * 4;

struct Group {
  const float* a;
  const float* b;
  const float* g;
  const int* idx;
  float* da;  // null: no da for this group
  float* db;  // null: no db for this group
  int m, k, l, p;
  // da: column tiles, rows a block, blocks, first block, B staged or not,
  // the pairs a staged row of (g, idx) takes (odd: a warp's 4 rows fall in
  // distinct banks), the floats of one stage, steps of kDaRows a tile.
  int da_ktiles, da_rows, da_blocks, da_begin, da_staged, da_pstride;
  int da_stage, da_steps;
  // db: column tiles, l's a block and l tiles, rows a block and ranges,
  // first block, tile id (PC), padded K of the partial sums, floats a copy
  // of a (4, 2 or 1: the alignment of K and of a).
  int db_ktiles, db_lw, db_ltiles, db_rows, db_ranges, db_blocks, db_begin;
  int db_tile, kp, a_vec;
  float* part;       // partial sums [ranges][P][L][kp]
  int64_t sum_begin;  // first db element of this group in the summing pass
};

struct GroupTable {
  int count;
  Group g[kMaxGroups];
};

__device__ __forceinline__ int find_group(const GroupTable& t, int block,
                                          int Group::*begin) {
  int gi = 0;
  while (gi + 1 < t.count && block >= t.g[gi + 1].*begin) ++gi;
  return gi;
}

// Copy V floats global -> shared, asynchronously; zero-fill if !ok (src
// must still be a valid address). Both addresses are 4 * V-byte aligned.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(4 * V), "r"(ok ? 4 * V : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- da

// A block's work: column tile kt, rows [r0, r1), walked as tiles of
// kDaRows rows x kDaLChunk l's, (row tile, l chunk) in order. Each tile's
// g and idx land in one of two stages as (g, idx bits) pairs by cp.async,
// the next tile's copies in flight while this one is summed. Lane
// 8 * r + q of a warp owns row 4 * warp + r of the tile and the columns
// k0 + 4q .. k0 + 4q + 3. Staged B is [P][L][32] with the 16-byte chunks
// of row (p, l) swizzled, chunk c at c ^ (l % 8): the 8 lanes reading a row
// take all 32 banks, and a warp staging one column over 32 l's 8 of them.
template <bool STAGED>
__device__ __forceinline__ void da_block(const Group& g, int local,
                                         float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kq = lane & 7;
  const int row = warp * 4 + (lane >> 3);  // within a tile
  const int kt = local % g.da_ktiles;
  const int k0 = kt * kDaK;
  const int kc = k0 + 4 * kq;
  const int r0 = (local / g.da_ktiles) * g.da_rows;
  const int r1 = min(g.m, r0 + g.da_rows);
  float* bs = smem + 2 * g.da_stage;

  if (STAGED) {
    // b[p, k0:k0+32, :] element by element: a warp a column k at a time,
    // its lanes along l (contiguous in b).
    for (int p = 0; p < g.p; ++p) {
      for (int kk = warp; kk < kDaK; kk += kWarps) {
        const bool ok = k0 + kk < g.k;
        const float* src =
            g.b + (static_cast<size_t>(p) * g.k + k0 + kk) * g.l;
        for (int l = lane; l < g.l; l += 32) {
          cp_async<1>(bs + (p * g.l + l) * kDaK +
                          (((kk >> 2) ^ (l & 7)) << 2) + (kk & 3),
                      ok ? src + l : g.b, ok);
        }
      }
    }
    cp_async_commit();
  }

  const int lchunks = max(1, (g.l + kDaLChunk - 1) / kDaLChunk);
  const int tile_rows = kDaRows * g.da_steps;
  const int tiles = (r1 - r0 + tile_rows - 1) / tile_rows * lchunks;
  const auto issue = [&](int t) {
    float* stage = smem + (t % 2) * g.da_stage;
    const int m0 = r0 + t / lchunks * tile_rows;
    const int l0 = t % lchunks * kDaLChunk;
    const int lc = min(kDaLChunk, g.l - l0);
    for (int r = warp; r < tile_rows; r += kWarps) {
      const int m = m0 + r;
      const bool ok = m < r1;
      for (int j = lane; j < lc; j += 32) {
        const size_t o = static_cast<size_t>(m) * g.l + l0 + j;
        float* dst = stage + (r * g.da_pstride + j) * 2;
        cp_async<1>(dst, ok ? g.g + o : g.g, ok);
        cp_async<1>(dst + 1,
                    ok ? static_cast<const void*>(g.idx + o) : g.g, ok);
      }
    }
  };

  // One (g, idx) pair's term: g * b[p, kc:kc+4, l] into acc.
  const auto b4 = [&](int p, int l) {
    if (STAGED) {
      return *reinterpret_cast<const float4*>(
          bs + (p * g.l + l) * kDaK + ((kq ^ (l & 7)) << 2));
    }
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = kc + c < g.k
                 ? __ldg(g.b + (static_cast<size_t>(p) * g.k + kc + c) * g.l +
                         l)
                 : 0.f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  };

  if (tiles > 0) issue(0);
  cp_async_commit();
  float acc[4];
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // B and tile t are in
    __syncthreads();
    const int lt = t % lchunks;
    const int l0 = lt * kDaLChunk;
    const int lc = min(kDaLChunk, g.l - l0);
    const int m0 = r0 + t / lchunks * tile_rows;
    // More than one step only where L <= 32, one l chunk: a step's rows
    // are summed whole. Otherwise acc runs across the l chunks.
    for (int step = 0; step < g.da_steps; ++step) {
      if (lt == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = 0.f;
      }
      const float2* pairs =
          reinterpret_cast<const float2*>(smem + (t % 2) * g.da_stage) +
          (step * kDaRows + row) * g.da_pstride;
      // Four l's at a time, their loads in flight together; the terms
      // still go in ascending l.
      int j = 0;
      for (; j + 4 <= lc; j += 4) {
        float2 v[4];
        float4 bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = pairs[j + u];
          bv[u] = b4(__float_as_int(v[u].y), l0 + j + u);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[0] = fmaf(v[u].x, bv[u].x, acc[0]);
          acc[1] = fmaf(v[u].x, bv[u].y, acc[1]);
          acc[2] = fmaf(v[u].x, bv[u].z, acc[2]);
          acc[3] = fmaf(v[u].x, bv[u].w, acc[3]);
        }
      }
      for (; j < lc; ++j) {
        const float2 v = pairs[j];
        const float4 bv = b4(__float_as_int(v.y), l0 + j);
        acc[0] = fmaf(v.x, bv.x, acc[0]);
        acc[1] = fmaf(v.x, bv.y, acc[1]);
        acc[2] = fmaf(v.x, bv.z, acc[2]);
        acc[3] = fmaf(v.x, bv.w, acc[3]);
      }
      const int m = m0 + step * kDaRows + row;
      if (lt == lchunks - 1 && m < r1) {
        float* out = g.da + static_cast<size_t>(m) * g.k;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (kc + c < g.k) out[kc + c] = acc[c];
        }
      }
    }
    __syncthreads();  // stage t % 2 read before it is refilled
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kThreads, 2)
score_grad_da_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(16) float smem[];
  const int gi = find_group(table, blockIdx.x, &Group::da_begin);
  const Group& g = table.g[gi];
  const int local = blockIdx.x - g.da_begin;
  if (g.da_staged) {
    da_block<true>(g, local, smem);
  } else {
    da_block<false>(g, local, smem);
  }
}

// ------------------------------------------------------------------- db

// Chunk `c` of a block's rows into `stage`: a [kDbRows][kDbK] in V-float
// copies, g and idx [kDbL][kDbRows]; rows past r1 and columns past K
// zero-filled.
template <int V>
__device__ __forceinline__ void db_issue(const Group& g, int m0, int r1,
                                         int k0, int l0, int lw,
                                         float* stage) {
  constexpr int kPerRow = kDbK / V;
  for (int e = threadIdx.x; e < kDbRows * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * V;
    const int m = m0 + r;
    const bool ok = m < r1 && k0 + c < g.k;
    cp_async<V>(stage + r * kDbK + c,
                ok ? g.a + static_cast<size_t>(m) * g.k + k0 + c : g.a, ok);
  }
  float* gs = stage + kDbRows * kDbK;
  float* is = gs + kDbL * kDbRows;
  for (int e = threadIdx.x; e < kDbRows * lw; e += kThreads) {
    const int j = e / kDbRows;
    const int r = e % kDbRows;
    const int m = m0 + r;
    const bool ok = m < r1;
    const size_t o = static_cast<size_t>(m) * g.l + l0 + j;
    cp_async<1>(gs + j * kDbRows + r, ok ? g.g + o : g.g, ok);
    cp_async<1>(is + j * kDbRows + r,
                ok ? static_cast<const void*>(g.idx + o) : g.g, ok);
  }
}

// A block's work: column tile kt (4 columns a lane), l tile lt (one l a
// warp) and the rows of one range, walked in chunks of kDbRows, the next
// chunk's copies in flight while this one is summed; each slot's terms
// are added in ascending m.
template <int PC>
__device__ __forceinline__ void db_block(const Group& g, int local,
                                         float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kt = local % g.db_ktiles;
  const int lt = (local / g.db_ktiles) % g.db_ltiles;
  const int range = local / (g.db_ktiles * g.db_ltiles);
  const int k0 = kt * kDbK;
  const int l0 = lt * g.db_lw;
  const int lw = min(g.db_lw, g.l - l0);
  const int r0 = range * g.db_rows;
  const int r1 = min(g.m, r0 + g.db_rows);
  const int chunks = (r1 - r0 + kDbRows - 1) / kDbRows;
  const auto issue = [&](int c) {
    float* stage = smem + (c % 2) * kDbStage;
    const int m0 = r0 + c * kDbRows;
    switch (g.a_vec) {
      case 4: db_issue<4>(g, m0, r1, k0, l0, lw, stage); break;
      case 2: db_issue<2>(g, m0, r1, k0, l0, lw, stage); break;
      default: db_issue<1>(g, m0, r1, k0, l0, lw, stage); break;
    }
  };

  for (int p0 = 0; p0 < g.p; p0 += PC) {
    float acc[PC][4];
#pragma unroll
    for (int q = 0; q < PC; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[q][t] = 0.f;
    }
    issue(0);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) issue(c + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk c is in
      __syncthreads();
      if (warp < lw) {
        const float* as = smem + (c % 2) * kDbStage;
        const float* gs = as + kDbRows * kDbK + warp * kDbRows;
        const int* is = reinterpret_cast<const int*>(gs + kDbL * kDbRows);
        const int m0 = r0 + c * kDbRows;
        for (int rg = 0; rg < kDbRows; rg += 32) {
          const bool live = m0 + rg + lane < r1;
          const int vi = is[rg + lane];
          const float vg = gs[rg + lane];
#pragma unroll
          for (int q = 0; q < PC; ++q) {
            unsigned rows = __ballot_sync(0xffffffffu, live && vi == p0 + q);
            while (rows) {  // ascending m; warp-uniform
              const int j = __ffs(rows) - 1;
              rows &= rows - 1;
              const float gv = __shfl_sync(0xffffffffu, vg, j);
              const float4 av = *reinterpret_cast<const float4*>(
                  as + (rg + j) * kDbK + lane * 4);
              acc[q][0] = fmaf(gv, av.x, acc[q][0]);
              acc[q][1] = fmaf(gv, av.y, acc[q][1]);
              acc[q][2] = fmaf(gv, av.z, acc[q][2]);
              acc[q][3] = fmaf(gv, av.w, acc[q][3]);
            }
          }
        }
      }
      __syncthreads();  // stage c % 2 read before it is refilled
    }
    cp_async_wait<0>();
    if (warp < lw) {
      const int l = l0 + warp;
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        if (p0 + q < g.p) {
          float* dst =
              g.part +
              ((static_cast<size_t>(range) * g.p + p0 + q) * g.l + l) * g.kp +
              k0 + lane * 4;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        }
      }
    }
  }
}

// Three resident blocks an SM (registers capped at 80 a thread; PC = 12
// spills a little) ran faster on the H100 than two without spills.
__global__ void __launch_bounds__(kThreads, 3)
score_grad_db_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(16) float smem[];
  const int gi = find_group(table, blockIdx.x, &Group::db_begin);
  const Group& g = table.g[gi];
  const int local = blockIdx.x - g.db_begin;
  switch (g.db_tile) {
    case 0: db_block<12>(g, local, smem); break;
    case 1: db_block<6>(g, local, smem); break;
    case 2: db_block<2>(g, local, smem); break;
    default: db_block<1>(g, local, smem); break;
  }
}

// db[p, k, l] = the sum over ranges, in range order, of the partial sums.
// One thread an element, k fastest (the partial sums' inner dimension).
__global__ void __launch_bounds__(kThreads)
score_grad_db_sum_kernel(const __grid_constant__ GroupTable table,
                         int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    int gi = 0;
    while (gi + 1 < table.count && e >= table.g[gi + 1].sum_begin) ++gi;
    const Group& g = table.g[gi];
    int64_t r = e - g.sum_begin;
    const int k = static_cast<int>(r % g.k);
    r /= g.k;
    const int l = static_cast<int>(r % g.l);
    const int p = static_cast<int>(r / g.l);
    const size_t step = static_cast<size_t>(g.p) * g.l * g.kp;
    const float* src =
        g.part + (static_cast<size_t>(p) * g.l + l) * g.kp + k;
    float s = 0.f;
    for (int range = 0; range < g.db_ranges; ++range) s += src[range * step];
    g.db[(static_cast<size_t>(p) * g.k + k) * g.l + l] = s;
  }
}

int ceil_div(int64_t x, int64_t y) { return static_cast<int>((x + y - 1) / y); }

// db's tile id for P permutations: the smallest PC in {1, 2, 6, 12} that
// holds min(P, 12), as the forward's tile_for.
int db_tile_for(int p) {
  if (p == 1) return 3;
  if (p == 2) return 2;
  if (p <= 6) return 1;
  return 0;
}

// Floats a copy can move: the widest of 4, 2, 1 that divides the row
// length and the tile's start columns and to whose bytes the base address
// is aligned.
int copy_width(int64_t ptr, int row, int tile_cols) {
  for (int v = 4; v > 1; v /= 2) {
    if (row % v == 0 && tile_cols % v == 0 && ptr % (4 * v) == 0) return v;
  }
  return 1;
}

// Allow both kernels' dynamic shared memory, once per device.
int allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(score_grad_da_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDaMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(score_grad_db_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDbSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace

// Fills `table` from the launch arguments (see
// molkgnn_support_score_backward), the partial sums of the groups laid out
// one after another from `scratch`. Returns -1 for arguments the kernels do
// not take, else 0; sets the blocks of da and db, da's dynamic shared
// memory, the elements of the summing pass and the floats of scratch.
static int plan(int num_groups, const int64_t* args, float* scratch,
                GroupTable& table, int& da_blocks, int& db_blocks,
                int& da_smem, int64_t& sum_total, int64_t& part_floats) {
  if (num_groups < 1 || num_groups > kMaxGroups) return -1;
  table.count = num_groups;
  da_blocks = db_blocks = 0;
  da_smem = 0;
  sum_total = part_floats = 0;
  for (int i = 0; i < num_groups; ++i) {
    const int64_t* v = args + 10 * i;
    const int64_t m = v[6], k = v[7], l = v[8], p = v[9];
    if (m < 0 || k < 0 || l < 0 || p < 1) return -1;
    if (m * k > INT32_MAX || m * l > INT32_MAX || p * k * l > INT32_MAX) {
      return -1;
    }
    Group& g = table.g[i];
    g.a = reinterpret_cast<const float*>(v[0]);
    g.b = reinterpret_cast<const float*>(v[1]);
    g.g = reinterpret_cast<const float*>(v[2]);
    g.idx = reinterpret_cast<const int*>(v[3]);
    g.da = reinterpret_cast<float*>(v[4]);
    g.db = reinterpret_cast<float*>(v[5]);
    g.m = static_cast<int>(m);
    g.k = static_cast<int>(k);
    g.l = static_cast<int>(l);
    g.p = static_cast<int>(p);

    // da: 32-row tiles, split into ranges so that the group has about
    // kTargetBlocks blocks.
    g.da_ktiles = ceil_div(k, kDaK);
    g.da_begin = da_blocks;
    g.da_blocks = 0;
    g.da_rows = kDaRows;
    g.da_staged = p * l * kDaK * 4 <= kDaBBudget;
    const int lc = static_cast<int>(std::min<int64_t>(l, kDaLChunk));
    g.da_pstride = lc | 1;
    g.da_steps = std::max(1, kDaLChunk / std::max(lc, 1));
    g.da_stage = kDaRows * g.da_steps * g.da_pstride * 2;
    if (g.da != nullptr && m > 0 && k > 0) {
      const int tile_rows = kDaRows * g.da_steps;
      const int tiles = ceil_div(m, tile_rows);
      const int ranges =
          std::min(tiles, std::max(1, ceil_div(kTargetBlocks, g.da_ktiles)));
      g.da_rows = ceil_div(tiles, ranges) * tile_rows;
      g.da_blocks = g.da_ktiles * ceil_div(m, g.da_rows);
      const int smem = 2 * g.da_stage * 4 +
                       (g.da_staged ? static_cast<int>(p * l) * kDaK * 4
                                    : 0);
      if (smem > da_smem) da_smem = smem;
    }
    da_blocks += g.da_blocks;

    // db: ranges of 64-row chunks, partial sums [ranges][P][L][kp].
    g.db_ktiles = ceil_div(k, kDbK);
    g.kp = g.db_ktiles * kDbK;
    g.db_ltiles = ceil_div(l, kDbL);
    g.db_lw = l > 0 ? ceil_div(l, g.db_ltiles) : 1;
    g.db_tile = db_tile_for(g.p);
    g.a_vec = copy_width(v[0], g.k, kDbK);
    g.db_begin = db_blocks;
    g.db_blocks = 0;
    g.db_ranges = 0;
    g.db_rows = kDbRows;
    g.part = nullptr;
    g.sum_begin = sum_total;
    if (g.db != nullptr) {
      const int tiles = g.db_ktiles * g.db_ltiles;
      if (m > 0 && tiles > 0) {
        const int chunks = ceil_div(m, kDbRows);
        const int ranges =
            std::min(chunks, std::max(1, ceil_div(kTargetBlocks, tiles)));
        g.db_rows = ceil_div(chunks, ranges) * kDbRows;
        g.db_ranges = ceil_div(m, g.db_rows);
        g.db_blocks = tiles * g.db_ranges;
        g.part = scratch == nullptr ? nullptr : scratch + part_floats;
        part_floats += static_cast<int64_t>(g.db_ranges) * p * l * g.kp;
      }
      sum_total += p * k * l;
    }
    db_blocks += g.db_blocks;
  }
  return 0;
}

extern "C" {

// Floats of scratch that molkgnn_support_score_backward needs for these
// groups (the partial sums of db), or -1 for arguments it does not take.
int64_t molkgnn_support_score_backward_scratch(int num_groups,
                                               const int64_t* args) {
  GroupTable table;
  int da_blocks, db_blocks, da_smem;
  int64_t sum_total, part_floats;
  if (plan(num_groups, args, nullptr, table, da_blocks, db_blocks, da_smem,
           sum_total, part_floats) != 0) {
    return -1;
  }
  return part_floats;
}

// The scorer's backward for `num_groups` groups on `stream`. `args` holds 10
// values a group, in the order the blocks are to be laid out: a, b, g, idx,
// da, db (device addresses; da or db 0 where that gradient is not wanted),
// then M, K, L, P. `scratch` (16-byte aligned, `scratch_floats` long) takes
// db's partial sums. Returns 0, a cudaError_t, or -1 for arguments the
// kernels do not take (too many groups, P < 1, negative sizes, sizes past
// int32, too little or misaligned scratch).
int molkgnn_support_score_backward(int num_groups, const int64_t* args,
                                   float* scratch, int64_t scratch_floats,
                                   void* stream) {
  GroupTable table;
  int da_blocks, db_blocks, da_smem;
  int64_t sum_total, part_floats;
  if (plan(num_groups, args, scratch, table, da_blocks, db_blocks, da_smem,
           sum_total, part_floats) != 0) {
    return -1;
  }
  if (part_floats > scratch_floats ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return -1;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (da_blocks > 0) {
    const int err = allow_smem();
    if (err != 0) return err;
    score_grad_da_kernel<<<da_blocks, kThreads, da_smem, s>>>(table);
  }
  if (db_blocks > 0) {
    const int err = allow_smem();
    if (err != 0) return err;
    score_grad_db_kernel<<<db_blocks, kThreads, kDbSmem, s>>>(table);
  }
  if (sum_total > 0) {
    const int64_t blocks = (sum_total + kThreads - 1) / kThreads;
    score_grad_db_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks
                                                                : 4096),
                               kThreads, 0, s>>>(table, sum_total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the three kernels on the current device: registers a
// thread, static shared memory (bytes), local memory a thread (bytes,
// spills) and resident blocks per SM at the largest dynamic shared memory
// each takes. Fills out[4 * 3]; returns 0 or a cudaError_t.
int molkgnn_support_score_backward_facts(int* out) {
  int err = allow_smem();
  if (err != 0) return err;
  const void* kernels[3] = {
      reinterpret_cast<const void*>(score_grad_da_kernel),
      reinterpret_cast<const void*>(score_grad_db_kernel),
      reinterpret_cast<const void*>(score_grad_db_sum_kernel),
  };
  const int smem[3] = {kDaMaxSmem, kDbSmem, 0};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes attr;
    err = static_cast<int>(cudaFuncGetAttributes(&attr, kernels[i]));
    if (err != 0) return err;
    int blocks = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernels[i], kThreads, smem[i]));
    if (err != 0) return err;
    out[4 * i] = attr.numRegs;
    out[4 * i + 1] = static_cast<int>(attr.sharedSizeBytes);
    out[4 * i + 2] = static_cast<int>(attr.localSizeBytes);
    out[4 * i + 3] = blocks;
  }
  return 0;
}

const char* molkgnn_support_score_backward_error_string(int code) {
  if (code == -1) return "invalid arguments for the support scorer backward";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// is fp32 with fmaf, k ascending.
//
// What bounds it on this card. Each group is one GEMM, [M, K] x [K, P*L],
// followed by a max over p. At the flagship shapes that is about
// 2 * M * K * L * P fp32 operations against (M*K + P*K*L) * 4 + M*L*8 bytes,
// some 90 operations per byte at the N-hop layers: far above the ridge point
// of the fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s, 20 per byte). So the
// bound is the fp32 FMA rate. What holds a kernel of this shape below it is
// the traffic into and out of shared memory, which competes with the FMAs
// for issue slots. The design:
//
//   * Block tile. A block owns BM rows x BL kernels x PC permutations of one
//     group (200 x 10 x 12 at P = 12) and walks K in chunks of 32, staged in
//     shared memory in 2 stages filled with cp.async: the copies of the next
//     chunk run while the FMAs of this one do.
//   * A is copied as it lies, [BM][32] row-major, in 16-, 8- or 4-byte
//     pieces: the widest that the row stride (K = 440 and 28*d: 16 bytes;
//     K = 110 and 330: 8 bytes; K = 3: 4 bytes) and the base address allow.
//     Ragged rows and the K tail are zero-filled (cp.async source size 0).
//     A is never copied in device memory.
//   * B is packed first, by a small kernel in the same call, into a scratch
//     buffer as [kernel tile][pass][k][BL][PC] (permutations innermost,
//     zero-padded to whole tiles and K chunks). A chunk of B is then one
//     contiguous run, copied in 16-byte pieces with no masks, and a thread's
//     TL * PC values of one k are contiguous in shared memory. B is small
//     (at most 1.1 MB a launch at the flagship shapes), so the packing costs
//     a few microseconds.
//   * Register tile. Each thread accumulates TM rows x TL kernels x PC
//     permutations (96 accumulators at P = 12 and P = 6). Per 4 k steps it
//     reads TM float4 of A; per k step TL * PC floats of B, in 16-byte
//     loads where the tile allows; then it issues TM * TL * PC FMAs: 96 FMAs
//     per 5 shared-memory loads at P = 12.
//   * Shapes per P. The tile is a template on PC, instantiated for the
//     flagship P = 1, 2, 6 and 12, with BL = 10, 20, 30 and 10 so that the
//     flagship L = 10/20/30/50 leave no lane idle. Any other P runs on the
//     instantiation of the next larger PC, in passes of PC permutations
//     (P > 12 in passes of 12); the epilogue masks the unused slots.
//   * Epilogue. max/argmax over p in registers, ascending p, strict '>';
//     the [M, L, P] scores never reach device memory.
//   * Schedule. The wrapper passes the groups heaviest first (M*K*L*P), and
//     blocks are laid out in that order, so the small degree-1 tiles fill
//     the tail of the launch.
//
// Left for later: the tensor cores. TF32 is too coarse for the 1e-5
// tolerance and the argmax contract; 3xTF32 on wgmma needs B K-major and a
// TMA-compatible (16-byte) row stride of A.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kChunkK = 32;  // K columns per shared-memory stage
constexpr int kMaxGroups = 16;
constexpr int kNumTiles = 4;

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// A block's tile: PC permutations, TM x TL outputs a thread, TX x TY
// threads (the rest of the 256 only load). A thread owns the rows
// ty + i * TY (i < TM), so that a warp's few distinct rows of A fall in
// different banks, and the kernels tx * TL + j (j < TL).
template <int PC_, int TM_, int TL_, int TX_, int TY_>
struct Tile {
  static constexpr int PC = PC_, TM = TM_, TL = TL_, TX = TX_, TY = TY_;
  static constexpr int BM = TY * TM;  // rows of A per block
  static constexpr int BL = TX * TL;  // kernels per block
  // Shared memory of one stage: A as [BM][A_STRIDE] (row-major, as in
  // memory), B as [kChunkK][B_STRIDE] with a row holding [BL][PC]
  // (permutations innermost, so that a thread's TL * PC values of one k
  // are contiguous). Both strides are multiples of 4 floats, for 16-byte
  // copies and loads; A's is kChunkK + 4 (an odd number of 16-byte units),
  // so that a warp's few distinct rows hit distinct banks.
  static constexpr int A_STRIDE = kChunkK + 4;
  static constexpr int B_STRIDE = round4(BL * PC);
  static constexpr int A_FLOATS = BM * A_STRIDE;
  static constexpr int STAGE = A_FLOATS + kChunkK * B_STRIDE;  // floats
  static constexpr int SMEM = kStages * STAGE * 4;                 // bytes
  static_assert(TX * TY <= kThreads, "tile needs more threads than a block");
};

// Tile ids, chosen on the host by P (tile_for).
using Tile12 = Tile<12, 8, 1, 10, 25>;  // BM 200, BL 10: L = 50 in 5 tiles
using Tile6 = Tile<6, 8, 2, 15, 17>;    // BM 136, BL 30
using Tile2 = Tile<2, 8, 4, 5, 51>;     // BM 408, BL 20
using Tile1 = Tile<1, 4, 5, 2, 128>;    // BM 512, BL 10

struct Group {
  const float* a;
  const float* b;
  float* best;
  int* idx;
  int m, k, l, p;
  int tile;        // tile id
  int a_vec;       // floats per copy of A: 4, 2 or 1 (alignment of K, a)
  int l_tiles;     // ceil(l / BL)
  int tile_begin;  // first block of this group
  // b packed as [l_tiles][passes][k_rows][b_row]: for each block's kernels
  // and pass of PC permutations, each k row as [BL][PC] (zero-padded to
  // b_row floats, and to k_rows = a multiple of kChunkK rows), so that a
  // K chunk of B is one contiguous run of kChunkK * b_row floats.
  float* bp;
  int bl, pc, b_row, passes, k_rows;
  int64_t pack_begin;  // first element of this group in the packing pass
};

struct GroupTable {
  int count;
  Group g[kMaxGroups];
};

// Copy V floats global -> shared, asynchronously; zero-fill if !ok. Both
// addresses are 4 * V-byte aligned.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
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

// A[m0 : m0 + BM, k0 : k0 + kChunkK] -> stage, V floats a copy
// (K % V == 0). Rows past M and columns past K are zero-filled.
template <class T, int V>
__device__ __forceinline__ void load_a(const Group& g, int m0, int k0,
                                       float* stage) {
  constexpr int kPerRow = kChunkK / V;
  constexpr int kCopies = T::BM * kPerRow;
#pragma unroll 1
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kCopies % kThreads == 0 || e < kCopies) {
      const int r = e / kPerRow;
      const int k = k0 + (e % kPerRow) * V;
      const bool ok = m0 + r < g.m && k < g.k;
      cp_async<V>(stage + r * T::A_STRIDE + (e % kPerRow) * V,
                  ok ? g.a + static_cast<size_t>(m0 + r) * g.k + k : g.a, ok);
    }
  }
}

// Chunk `chunk` of packed B for kernel tile t and pass `pass` -> stage:
// one contiguous run, copied in 16-byte pieces.
template <class T>
__device__ __forceinline__ void load_b(const Group& g, int t, int pass,
                                       int chunk, float* stage) {
  constexpr int kCopies = kChunkK * T::B_STRIDE / 4;
  const float* src =
      g.bp + ((static_cast<size_t>(t) * g.passes + pass) * g.k_rows +
              chunk * kChunkK) *
                 T::B_STRIDE;
  float* dst = stage + T::A_FLOATS;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kCopies % kThreads == 0 || e < kCopies) {
      cp_async<4>(dst + 4 * e, src + 4 * e, true);
    }
  }
}

// Issue the copies of K chunk `chunk` of kernel tile t and permutation
// pass `pass` into `stage`.
template <class T>
__device__ __forceinline__ void load_chunk(const Group& g, int m0, int t,
                                           int pass, int chunk,
                                           float* stage) {
  const int k0 = chunk * kChunkK;
  switch (g.a_vec) {
    case 4: load_a<T, 4>(g, m0, k0, stage); break;
    case 2: load_a<T, 2>(g, m0, k0, stage); break;
    default: load_a<T, 1>(g, m0, k0, stage); break;
  }
  load_b<T>(g, t, pass, chunk, stage);
}

// N contiguous floats from shared memory, in 16-byte loads where N allows.
template <int N>
__device__ __forceinline__ void load_frag(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      dst[j] = v.x;
      dst[j + 1] = v.y;
      dst[j + 2] = v.z;
      dst[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = src[j];
  }
}

template <class T>
__device__ __forceinline__ void score_tile(const Group& g, int local,
                                           float* smem) {
  constexpr int TM = T::TM, TL = T::TL, PC = T::PC;
  const int tid = threadIdx.x;
  const int m0 = (local / g.l_tiles) * T::BM;
  const int t = local % g.l_tiles;  // kernel tile
  const int l0 = t * T::BL;
  const bool computes = tid < T::TX * T::TY;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const int chunks = (g.k + kChunkK - 1) / kChunkK;

  float best[TM][TL];
  int arg[TM][TL];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      best[i][j] = 0.f;
      arg[i][j] = 0;
    }
  }

  for (int p0 = 0; p0 < g.p; p0 += PC) {
    const int pc = min(PC, g.p - p0);
    float acc[TM][TL][PC];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TL; ++j) {
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[i][j][q] = 0.f;
      }
    }

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < chunks) load_chunk<T>(g, m0, t, p0 / PC, s, smem + s * T::STAGE);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is in; chunk c - 1 has been read
      const int next = c + kStages - 1;
      if (next < chunks) {
        load_chunk<T>(g, m0, t, p0 / PC, next,
                      smem + (next % kStages) * T::STAGE);
      }
      cp_async_commit();
      if (computes) {
        const float* as = smem + (c % kStages) * T::STAGE + ty * T::A_STRIDE;
        const float* bs =
            smem + (c % kStages) * T::STAGE + T::A_FLOATS + tx * TL * PC;
#pragma unroll 2
        for (int k4 = 0; k4 < kChunkK; k4 += 4) {
          float4 av[TM];  // rows i, k = k4 .. k4 + 3
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            av[i] = *reinterpret_cast<const float4*>(
                as + i * T::TY * T::A_STRIDE + k4);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float bv[TL * PC];  // [j][q]
            load_frag<TL * PC>(bs + (k4 + s) * T::B_STRIDE, bv);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float a = s == 0   ? av[i].x
                              : s == 1 ? av[i].y
                              : s == 2 ? av[i].z
                                       : av[i].w;
#pragma unroll
              for (int j = 0; j < TL; ++j) {
#pragma unroll
                for (int q = 0; q < PC; ++q) {
                  acc[i][j][q] = fmaf(a, bv[j * PC + q], acc[i][j][q]);
                }
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every stage read before the next pass refills it

    // Reduce this pass's permutations in ascending order; strict '>'
    // keeps the first max.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TL; ++j) {
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          if (q < pc && (p0 + q == 0 || acc[i][j][q] > best[i][j])) {
            best[i][j] = acc[i][j][q];
            arg[i][j] = p0 + q;
          }
        }
      }
    }
  }

  if (computes) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * T::TY;
      if (m >= g.m) break;
#pragma unroll
      for (int j = 0; j < TL; ++j) {
        const int l = l0 + tx * TL + j;
        if (l < g.l) {
          const size_t o = static_cast<size_t>(m) * g.l + l;
          g.best[o] = best[i][j];
          g.idx[o] = arg[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
support_score_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(16) float smem[];
  int gi = 0;
  while (gi + 1 < table.count &&
         static_cast<int>(blockIdx.x) >= table.g[gi + 1].tile_begin) {
    ++gi;
  }
  const Group& g = table.g[gi];
  const int local = blockIdx.x - g.tile_begin;
  switch (g.tile) {
    case 0: score_tile<Tile12>(g, local, smem); break;
    case 1: score_tile<Tile6>(g, local, smem); break;
    case 2: score_tile<Tile2>(g, local, smem); break;
    default: score_tile<Tile1>(g, local, smem); break;
  }
}

// Packs each group's b [P, K, L] into the layout of Group::bp. One thread
// an element of the packed arrays, which are written in order.
__global__ void __launch_bounds__(kThreads)
support_score_pack_b(const __grid_constant__ GroupTable table,
                     int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    int gi = 0;
    while (gi + 1 < table.count && e >= table.g[gi + 1].pack_begin) ++gi;
    const Group& g = table.g[gi];
    int64_t r = e - g.pack_begin;
    const int col = static_cast<int>(r % g.b_row);
    r /= g.b_row;
    const int k = static_cast<int>(r % g.k_rows);
    r /= g.k_rows;
    const int pass = static_cast<int>(r % g.passes);
    const int t = static_cast<int>(r / g.passes);
    const int l = t * g.bl + col / g.pc;
    const int p = pass * g.pc + col % g.pc;
    float v = 0.f;
    if (col < g.bl * g.pc && l < g.l && p < g.p && k < g.k) {
      v = g.b[(static_cast<size_t>(p) * g.k + k) * g.l + l];
    }
    g.bp[e - g.pack_begin] = v;
  }
}

// Tile id, rows, kernels, permutations a pass, packed row length of B and
// bytes of shared memory for a group of P permutations: the smallest PC in
// {1, 2, 6, 12} that holds min(P, 12).
struct TileShape {
  int id, bm, bl, pc, b_row, smem;
};

// Floats a copy can move: the widest of 4, 2, 1 that divides the row
// length and the tile's start columns and to whose bytes the base address
// is aligned.
int copy_width(int64_t ptr, int row, int tile_cols) {
  for (int v = 4; v > 1; v /= 2) {
    if (row % v == 0 && tile_cols % v == 0 && ptr % (4 * v) == 0) return v;
  }
  return 1;
}

template <class T>
constexpr TileShape shape_of(int id) {
  return {id, T::BM, T::BL, T::PC, T::B_STRIDE, T::SMEM};
}

TileShape tile_for(int p) {
  if (p == 1) return shape_of<Tile1>(3);
  if (p == 2) return shape_of<Tile2>(2);
  if (p <= 6) return shape_of<Tile6>(1);
  return shape_of<Tile12>(0);
}

constexpr int cmax(int x, int y) { return x > y ? x : y; }
constexpr int kMaxSmem =
    cmax(cmax(Tile12::SMEM, Tile6::SMEM), cmax(Tile2::SMEM, Tile1::SMEM));

// Allow the largest tile's dynamic shared memory, once per device.
int allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(support_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace

// Fills `table` from the launch arguments (see molkgnn_support_score), with
// the packed B of the groups laid out one after another from `scratch`.
// Returns -1 for arguments the kernel does not take, else 0; sets the
// blocks, the dynamic shared memory and the floats of packed B.
static int plan(int num_groups, const int64_t* args, float* scratch,
                GroupTable& table, int& tiles, int& smem, int64_t& packed) {
  if (num_groups < 1 || num_groups > kMaxGroups) return -1;
  table.count = num_groups;
  tiles = 0;
  smem = 0;
  packed = 0;
  for (int i = 0; i < num_groups; ++i) {
    const int64_t* v = args + 8 * i;
    if (v[4] < 0 || v[5] < 0 || v[6] < 0 || v[7] < 1) return -1;
    if (v[4] > INT32_MAX || v[5] > INT32_MAX || v[6] > INT32_MAX ||
        v[7] > INT32_MAX) {
      return -1;
    }
    Group& g = table.g[i];
    g.a = reinterpret_cast<const float*>(v[0]);
    g.b = reinterpret_cast<const float*>(v[1]);
    g.best = reinterpret_cast<float*>(v[2]);
    g.idx = reinterpret_cast<int*>(v[3]);
    g.m = static_cast<int>(v[4]);
    g.k = static_cast<int>(v[5]);
    g.l = static_cast<int>(v[6]);
    g.p = static_cast<int>(v[7]);
    const TileShape t = tile_for(g.p);
    g.tile = t.id;
    g.a_vec = copy_width(v[0], g.k, kChunkK);
    g.l_tiles = (g.l + t.bl - 1) / t.bl;
    g.tile_begin = tiles;
    const int blocks = ((g.m + t.bm - 1) / t.bm) * g.l_tiles;
    tiles += blocks;
    if (blocks > 0 && t.smem > smem) smem = t.smem;
    g.bl = t.bl;
    g.pc = t.pc;
    g.b_row = t.b_row;
    g.passes = (g.p + t.pc - 1) / t.pc;
    g.k_rows = (g.k + kChunkK - 1) / kChunkK * kChunkK;
    g.pack_begin = packed;
    g.bp = scratch == nullptr ? nullptr : scratch + packed;
    if (blocks > 0) {
      packed +=
          static_cast<int64_t>(g.l_tiles) * g.passes * g.k_rows * g.b_row;
    }
  }
  return 0;
}

extern "C" {

// Floats of scratch that molkgnn_support_score needs for these groups (the
// packed B), or -1 for arguments the kernel does not take.
int64_t molkgnn_support_score_scratch(int num_groups, const int64_t* args) {
  GroupTable table;
  int tiles, smem;
  int64_t packed;
  if (plan(num_groups, args, nullptr, table, tiles, smem, packed) != 0) {
    return -1;
  }
  return packed;
}

// Scores `num_groups` groups on `stream`: packs B into `scratch` (16-byte
// aligned, `scratch_floats` long), then launches the scorer. `args` holds
// 8 values per group, in the order the blocks are to be laid out: a, b,
// best, idx (device addresses), then M, K, L, P. Returns 0, a cudaError_t,
// or -1 for arguments the kernel does not take (too many groups, P < 1,
// negative sizes, too little or misaligned scratch).
int molkgnn_support_score(int num_groups, const int64_t* args, float* scratch,
                          int64_t scratch_floats, void* stream) {
  GroupTable table;
  int tiles, smem;
  int64_t packed;
  if (plan(num_groups, args, scratch, table, tiles, smem, packed) != 0) {
    return -1;
  }
  if (packed > scratch_floats ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return -1;
  }
  if (tiles == 0) return 0;
  const int err = allow_smem();
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t pack_blocks = (packed + kThreads - 1) / kThreads;
  support_score_pack_b<<<static_cast<int>(pack_blocks < 1024 ? pack_blocks
                                                              : 1024),
                         kThreads, 0, s>>>(table, packed);
  support_score_kernel<<<tiles, kThreads, smem, s>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the kernel on the current device, for each of the
// kNumTiles tiles: registers a thread, static and dynamic shared memory
// (bytes), resident blocks per SM, local memory a thread (bytes, spills),
// and the tile's P chunk, rows and kernels. Fills out[9 * kNumTiles];
// returns 0 or a cudaError_t.
int molkgnn_support_score_facts(int* out) {
  int err = allow_smem();
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, support_score_kernel));
  if (err != 0) return err;
  const int shape[kNumTiles][4] = {
      {Tile12::SMEM, Tile12::PC, Tile12::BM, Tile12::BL},
      {Tile6::SMEM, Tile6::PC, Tile6::BM, Tile6::BL},
      {Tile2::SMEM, Tile2::PC, Tile2::BM, Tile2::BL},
      {Tile1::SMEM, Tile1::PC, Tile1::BM, Tile1::BL},
  };
  for (int t = 0; t < kNumTiles; ++t) {
    int blocks = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, support_score_kernel, kThreads, shape[t][0]));
    if (err != 0) return err;
    int* o = out + 9 * t;
    o[0] = attr.numRegs;
    o[1] = static_cast<int>(attr.sharedSizeBytes);
    o[2] = shape[t][0];
    o[3] = blocks;
    o[4] = static_cast<int>(attr.localSizeBytes);
    o[5] = shape[t][1];
    o[6] = shape[t][2];
    o[7] = shape[t][3];
    o[8] = kThreads;
  }
  return 0;
}

const char* molkgnn_error_string(int code) {
  if (code == -1) return "invalid arguments for the support scorer";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

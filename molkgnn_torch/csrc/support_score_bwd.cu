// Backward of the permutation-max support scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the backward halves of the JAX package's two custom VJPs around
// its Pallas scorers, molkgnn_tpu/ops/pallas_kernels.py: _fss_bwd (line 76,
// behind _fused_support_score_vjp) and _grouped_bwd (line 251, behind
// _grouped_vjp). One entry point serves both: the fused call is G = 1.
//
// For every group, with a [M, K], b [P, K, L], the output gradient
// g [M, L] and the forward's argmax idx [M, L] (int32), the gradient flows
// only through the chosen permutation, as in the JAX VJPs:
//   da[m, k]    = sum_l g[m, l] * b[idx[m, l], k, l]
//   db[p, k, l] = sum_m [idx[m, l] == p] * a[m, k] * g[m, l]
//
// Both are computed as dense products on the tensor cores. With the one-hot
// matrix S[m, n] = g[m, l] * [idx[m, l] == p] over the N = P * L columns
// (p, l), and Bt[n, k] = b[p, k, l]:
//   da = S Bt            (a reduction over n: M x K x N multiply-adds)
//   db[p, :, l] = a^T S  (a reduction over m: K x N x M multiply-adds)
// S is never in device memory: da builds it in registers, db in shared
// memory, from g and idx. Each product runs as m64nNk8 TF32 `wgmma`s (N =
// 32C: C = 1 .. 4 in da, 1 .. 2 in db) with fp32 accumulators, each
// promoted into an fp32 sum every few steps (see Accuracy), the A operand
// from registers
// and B from shared memory, K-major without swizzle (core matrices of 8
// rows x 16 bytes; for tf32, wgmma reads shared memory only K-major). For
// fp32 accuracy each operand x is split into hi = tf32(x) and lo = tf32(x
// - hi) (cvt.rna: round to nearest, ties away from zero; split_tf32, the
// one split of both kernels) and every product is lo*hi + hi*lo + hi*hi
// ("3xTF32"). What the split drops, lo*lo and the rounding of lo, stands
// about 2^-22 of each term.
//
// What bounds it on this card. The function needs M*K*L multiply-adds for
// each of da and db and reads a, b, g, idx once and writes da and db once:
// at the flagship's shapes the bytes bind (0.029 ms at an N-hop layer at
// 3.35 TB/s). On the fp32 cores each of the M*K*L terms picks its
// operand by idx and so reads it from shared memory once a term. Here the
// one-hot operand costs nothing a term, but the
// products are dense over P: 22.6M * F multiply-adds a product at the
// flagship (F = 28 at layer 0, 110 at an N-hop layer), three times over
// for the split, padded to the tiles below (`tf32_work` in
// tools/backward_profile.py counts them: 110 GFLOP of TF32 a flagship
// train step, 0.22 ms at 495 TFLOP/s). On the H100 the tensor cores are
// not what binds: a k8 step's products are short against the instructions
// that build the step's one-hot fragment, and the streams of Bt (da, about
// 160 MB at an N-hop layer, one copy a block of 128 rows) and of a (db)
// into shared memory take most of the time; tools/backward_profile.py
// times them.
//
// The kernels, one launch each, for all groups at once:
//   * score_grad_pack_kernel: Bt's hi and lo, once a call, into scratch,
//     column tile after column tile in the layout of da's shared-memory
//     stages, with da's reduction order n' = l P + p.
//   * score_grad_da_kernel: a block owns 128 rows (64 a warpgroup, two
//     warpgroups) and up to 128 columns k. The rows' g (split into hi and
//     lo once) and idx wait in shared memory (L <= 50; else read from
//     device memory); Bt's tile streams through a ring of 4 stages of 4 k8
//     steps, one bulk copy a stage on the tensor memory accelerator
//     (cp.async.bulk with an mbarrier), two stages ahead. In the order
//     n' = l P + p a thread's two columns of a step are (p, l) by one
//     multiply with a reciprocal of P, so a fragment entry is a compare and
//     two selects, and one group of products stays in flight while the
//     next fragment is read. At the start of every stage (kDaPromoteSteps
//     = 4 steps) the warpgroup drains its products and promotes its
//     accumulator: 64 + 64 registers of accumulator and sum a thread at
//     128 columns.
//   * score_grad_db_kernel: a block owns 256 columns k (64 a warpgroup,
//     four warpgroups), up to 64 columns n and a fixed range of rows,
//     walked 32 rows at a time. a's rows land by cp.async in their natural
//     [m][k] layout (three stages) and each thread reads its a^T fragment
//     from there and splits it; while a chunk runs on the tensor cores all
//     threads build the next chunk's S (hi and lo, K-major: m contiguous
//     for each n) in the other of two buffers, reading g and idx through
//     L1. After each chunk, whose products the warpgroup drains anyway,
//     the accumulator is promoted (32 + 32 registers a thread, within the
//     128 of a 512-thread block). The range's sums go to scratch.
//   * score_grad_db_sum_kernel adds the ranges' partial sums into db
//     [P, K, L]. The ranges share about 132 blocks out among the groups by
//     their work, at most 32 kDbRangeChunks P rows a range: more blocks
//     than the work share alone gives, the fastest cap measured
//     (tools/backward_accuracy.py).
//
// The order of every sum, so that a call repeats bit for bit and does not
// depend on the order of blocks: no atomics. da[m, k] is one accumulator
// and one sum of one thread: the steps of 8 n' go into the accumulator in
// ascending n', each step as lo*hi, then hi*lo, then hi*hi, and every
// kDaPromoteSteps steps (and after the last) the accumulator is added into
// the sum (__fadd_rn) and the next product overwrites it. A db partial sum
// is the same over the steps of 8 rows of its range in ascending m, the
// accumulator promoted every kDbPromoteChunks chunks of 32 rows. db adds
// the ranges' sums in eight running sums, range r into sum r % 8 in
// ascending r, then ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)). The
// tensor cores' own order inside a step is fixed by the hardware. The
// kernels go on the caller's stream one after another and never
// synchronise with the host, so a CUDA graph captures them.
//
// Accuracy. The split alone stays within about 2x of fp32's error (summed
// in IEEE fp32), but the tensor cores round each accumulation into the
// fp32 accumulator toward zero, so a sum loses up to an ulp at each
// accumulation of its chain, always toward zero. Unpromoted, the chains
// were 3 a step over P L / 8 steps (da) and over the rows of a range (db),
// and at the flagship's grouped calls on an H100 da stood up to 10x and db
// up to 19x as far from fp64 as cuBLAS's fp32 products. Promotion (as FP8
// GEMMs on Hopper do it) cuts every chain to at most 4 steps, 12
// accumulations, and leaves the rest of the sum to IEEE fp32 adds in a
// fixed order: both gradients then stand within 2x of cuBLAS's distance
// (plus 2^-23 of the largest value) in every group of both calls
// (tools/backward_accuracy.py sweeps the intervals: da at 8 steps and db
// at 4 chunks fail it). support_score_backward_emulated in
// ops/support_score.py models this rounding on the CPU.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // the packing and summing passes
constexpr int kDaWarpgroups = 2;  // a block of da
constexpr int kDaThreads = 128 * kDaWarpgroups;
constexpr int kDbWarpgroups = 4;  // a block of db
constexpr int kDbThreads = 128 * kDbWarpgroups;
constexpr int kMaxGroups = 16;
constexpr int kChunk = 32;  // a tile's columns: 32C
constexpr int kMaxChunks = 2;  // db's columns of n a block, in chunks
constexpr int kTile = kChunk * kMaxChunks;
constexpr int kDaMaxChunks = 4;  // da's columns of k a block, in chunks
constexpr int kDaTile = kChunk * kDaMaxChunks;

// Promotion: a thread's wgmma accumulator takes the products of at most
// kDaPromoteSteps k8 steps (da; a whole number of stages) or of
// kDbPromoteChunks chunks of rows (db) from zero, and is then added into
// the thread's fp32 sum, rounded to nearest (see Accuracy).
constexpr int kDaPromoteSteps = 4;
constexpr int kDbPromoteChunks = 1;

// da stages g and idx in shared memory where L is at most kDaGiMaxL, else
// reads them from device memory; db reads them through L1.
constexpr int kDaGiMaxL = 50;

// da: rows a block (64 a warpgroup), k8 steps a stage,
// stages; a step of Bt is hi and lo, two core-matrix columns each:
// [2][2][tile][4]; then the block's g's hi and lo and idx, [rows][L] each.
constexpr int kDaRows = 64 * kDaWarpgroups;
constexpr int kDaSteps = 4;
constexpr int kDaStages = 4;
constexpr int kDaStageFloats = kDaSteps * 16 * kDaTile;
constexpr int kDaRingFloats = kDaStages * kDaStageFloats;
constexpr int kDaSmem = (kDaRingFloats + 3 * kDaRows * kDaGiMaxL) * 4;
static_assert(kDaPromoteSteps % kDaSteps == 0,
              "da promotes at the start of a stage");

// db: rows a chunk (4 k8 steps), columns k a block (64 a warpgroup), the
// padded row of a staged a (kDbK + 8 = 8 mod 32: a warp's
// fragment reads fall in 32 banks); a stage holds a chunk's a, a buffer
// S's hi and lo [2][kDbRows / 4][tile][4]; three stages, two buffers of S;
// blocks of all the groups together, shared out by the groups' work.
constexpr int kDbRows = 32;
constexpr int kDbK = 64 * kDbWarpgroups;
constexpr int kDbAStride = kDbK + 8;
constexpr int kDbAFloats = kDbRows * kDbAStride;
constexpr int kDbStageFloats = kDbAFloats;
constexpr int kDbStages = 3;
constexpr int kDbSFloats = 2 * kDbRows * kTile;
constexpr int kDbSmem = (kDbStages * kDbStageFloats + 2 * kDbSFloats) * 4;
constexpr int kDbBlocks = 132;
// db's a^T fragments in registers: one more than its groups of products in
// flight (two cost the 128-register block 8 bytes of spills).
constexpr int kDbFragments = 1;
// At most kDbRangeChunks P chunks of rows a db range, about 32
// kDbRangeChunks rows a partial sum: more ranges, and blocks, than the
// work share alone gives where P is small (the fastest cap measured by
// tools/backward_accuracy.py; promotion keeps the error from growing with a
// range's rows).
constexpr int kDbRangeChunks = 4;

struct Group {
  const float* a;
  const float* b;
  const float* g;
  const int* idx;
  float* da;  // null: no da for this group
  float* db;  // null: no db for this group
  int m, k, l, p;
  int n;       // P * L
  unsigned pinv;  // 2^32 / P + 1: l = (n' * pinv) >> 32 exactly; 0: P = 1
  unsigned linv;  // the same for L: p = (n * linv) >> 32, n = p L + l
  int nsteps;  // da's k8 steps over n' = l P + p, in whole stages
  int kp;      // K rounded up to kChunk: Bt's packed columns
  float* bt;   // packed Bt, hi and lo (score_grad_pack_kernel)
  int64_t pack_begin;  // first element of this group in the packing pass
  // da: column tiles, blocks, first block.
  int da_ktiles, da_blocks, da_begin;
  // db: column tiles of k and of n, chunks of n (the partial sums' padded
  // N is 32 db_nchunks), rows a range, ranges, blocks, first block, floats
  // a copy of a (4, 2 or 1).
  int db_ktiles, db_ntiles, db_nchunks, db_rows, db_ranges, db_blocks;
  int db_begin, a_vec;
  // The floats a copy of g and of idx moves (by their alignment).
  int g_vec, i_vec;
  float* part;        // partial sums [ranges][K][32 db_nchunks]
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

__device__ __forceinline__ int find_group64(const GroupTable& t, int64_t e,
                                            int64_t Group::*begin) {
  int gi = 0;
  while (gi + 1 < t.count && e >= t.g[gi + 1].*begin) ++gi;
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

// The thread's warpgroup, broadcast from lane 0 so that the
// compiler sees it warp-uniform: branches on it around wgmma do not make
// ptxas serialise the products.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
}

// count 4-byte values from src to dst by cp.async, V at a time (both 4V-byte
// aligned), the tail one at a time; a block of da's threads.
template <int V>
__device__ __forceinline__ void stage_flat_v(void* dst, const void* src,
                                             int count) {
  const int vec = count / V * V;
  float* d = static_cast<float*>(dst);
  const float* s = static_cast<const float*>(src);
  for (int e = threadIdx.x * V; e < vec; e += kDaThreads * V) {
    cp_async<V>(d + e, s + e, true);
  }
  for (int e = vec + threadIdx.x; e < count; e += kDaThreads) {
    cp_async<1>(d + e, s + e, true);
  }
}

__device__ __forceinline__ void stage_flat(void* dst, const void* src,
                                           int count, int v) {
  switch (v) {
    case 4: stage_flat_v<4>(dst, src, count); break;
    case 2: stage_flat_v<2>(dst, src, count); break;
    default: stage_flat_v<1>(dst, src, count); break;
  }
}

// Shared-memory writes of this thread (st.shared, cp.async) made visible
// to the tensor cores' reads (the async proxy); a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// An mbarrier in shared memory: one arrival (the thread that starts a bulk
// copy) plus the copy's bytes complete a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device to shared memory on the tensor memory accelerator, completing
// the current phase of `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until `bar` has completed the phase of parity `phase`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(a), "r"(phase) : "memory");
}

// ----------------------------------------------------------- 3xTF32, wgmma

// x = hi + lo + r, hi = tf32(x) and lo = tf32(x - hi) by round to nearest,
// ties away from zero; |r| <= 2^-22 |x| roughly. Both as fp32 bit patterns
// whose 13 low mantissa bits are 0, as the tensor cores read TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Descriptor of a K-major operand in shared memory without swizzle: core
// matrices of 8 rows x 16 bytes, contiguous; the next 16 bytes of K at
// `lbo` bytes, the next 8 rows at `sbo` bytes.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d[64 x 32C] = A[64 x 8] B[8 x 32C] (+ d where `accumulate` is not 0) on
// the warpgroup's tensor cores (m64n{32C}k8), TF32 in, fp32 accumulate (the
// wgmma's scale-d). A from registers: thread
// (warp w, lane) holds rows 16w + lane/4 (+8 in a[1], a[3]) and columns
// lane%4 (+4 in a[2], a[3]). d: row 16w + lane/4 (+8 in d[4j+2], d[4j+3]),
// column 8j + 2(lane%4) (+1 in d[4j+1], d[4j+3]).
template <int C>
__device__ __forceinline__ void mma_tf32(float (&d)[16 * C],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate);

// The operands of m64n{32C}k8: the accumulators' numbers in the
// instruction's text (%0 .. %(16C - 1)) and d[0 .. 16C - 1] as read-write
// operands; the A fragment, the descriptor and the accumulate flag follow
// as %(16C) .. %(16C + 5).
#define WG_REGS1 "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS2 WG_REGS1 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS3 WG_REGS2 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_REGS4 WG_REGS3 ", %48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D16(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7]),  \
      "+f"(d[i + 8]), "+f"(d[i + 9]), "+f"(d[i + 10]), "+f"(d[i + 11]), \
      "+f"(d[i + 12]), "+f"(d[i + 13]), "+f"(d[i + 14]), "+f"(d[i + 15])
#define WG_D1 WG_D16(0)
#define WG_D2 WG_D1, WG_D16(16)
#define WG_D3 WG_D2, WG_D16(32)
#define WG_D4 WG_D3, WG_D16(48)
#define WG_MMA_TF32(C, N, A0, A1, A2, A3, DESC, SCALE)                     \
  template <>                                                              \
  __device__ __forceinline__ void mma_tf32<C>(                             \
      float(&d)[16 * C], const uint32_t(&a)[4], uint64_t desc_b,          \
      int accumulate) {                                                    \
    asm volatile(                                                          \
        "{\n"                                                              \
        ".reg .pred p;\n"                                                  \
        "setp.ne.b32 p, %" #SCALE ", 0;\n"                                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"        \
        WG_REGS##C "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC \
        ", p, 1, 1;\n"                                                     \
        "}\n"                                                              \
        : WG_D##C                                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),        \
          "r"(accumulate));                                                \
  }
WG_MMA_TF32(1, 32, 16, 17, 18, 19, 20, 21)
WG_MMA_TF32(2, 64, 32, 33, 34, 35, 36, 37)
WG_MMA_TF32(3, 96, 48, 49, 50, 51, 52, 53)
WG_MMA_TF32(4, 128, 64, 65, 66, 67, 68, 69)
static_assert(kDaMaxChunks <= 4 && kMaxChunks <= 4,
              "mma_tf32 is defined for C <= 4");
#undef WG_MMA_TF32
#undef WG_D16
#undef WG_REGS1
#undef WG_D1
#undef WG_REGS2
#undef WG_D2
#undef WG_REGS3
#undef WG_D3
#undef WG_REGS4
#undef WG_D4

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep a register's value where it is up to this point: registers that an
// asynchronous wgmma reads or accumulates into are not reused or moved
// while it runs.
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

template <int C>
__device__ __forceinline__ void keep_acc(float (&acc)[16 * C]) {
#pragma unroll
  for (int j = 0; j < 16 * C; ++j) keep(acc[j]);
}

__device__ __forceinline__ void keep_frag(uint32_t (&f)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) keep(f[j]);
}

// One k8 step of a warpgroup's product (A from registers) with one B of
// 32C columns: lo*hi, hi*lo, hi*hi into one accumulator, which the first
// of them overwrites where `accumulate` is 0. b_hi and b_lo: B's hi and lo
// parts, K-major, the next 16 bytes of K `lbo` bytes on.
template <int C>
__device__ __forceinline__ void mma_step(float (&acc)[16 * C],
                                         const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4],
                                         const float* b_hi, const float* b_lo,
                                         uint32_t lbo, int accumulate) {
  const uint64_t dh = smem_desc(b_hi, lbo, 128);
  const uint64_t dl = smem_desc(b_lo, lbo, 128);
  mma_tf32<C>(acc, a_lo, dh, accumulate);
  mma_tf32<C>(acc, a_hi, dl, 1);
  mma_tf32<C>(acc, a_hi, dh, 1);
}

// Promotion: the accumulator's value, which the wgmmas have finished
// (wgmma.wait_group 0), added into the thread's sum rounded to nearest.
template <int C>
__device__ __forceinline__ void promote(float (&sum)[16 * C],
                                        const float (&acc)[16 * C]) {
#pragma unroll
  for (int j = 0; j < 16 * C; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);
}

// Calls body(std::integral_constant<int, C>) for C = min(chunks, kMax),
// at least 1, instantiating no C above kMax: a kernel takes the registers
// of its widest tile.
template <int kMax, typename Body>
__device__ __forceinline__ void with_chunks(int chunks, Body&& body) {
  if constexpr (kMax > 1) {
    if (chunks < kMax) {
      with_chunks<kMax - 1>(chunks, body);
      return;
    }
  }
  body(std::integral_constant<int, kMax>{});
}

// ------------------------------------------------------------------ pack

// Bt's hi and lo for every group that takes da, column tile after column
// tile (kDaTile columns, the last kp - kDaTile kt), each tile [nsteps][hl]
// [half][W][4]: element (step, hl, half, c, q) is the hi (hl 0) or lo part
// of b[p, k, l] at n' = 8 step + 4 half + q = l P + p and k = kDaTile kt +
// c; 0 past L or K. A stage of da (kDaSteps steps of a tile) is then one
// contiguous run.
__global__ void __launch_bounds__(kThreads)
score_grad_pack_kernel(const __grid_constant__ GroupTable table,
                       int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const Group& g = table.g[find_group64(table, e, &Group::pack_begin)];
    const int64_t tile = static_cast<int64_t>(g.nsteps) * 16 * kDaTile;
    const int64_t r = e - g.pack_begin;
    const int kt = static_cast<int>(r / tile);
    const int w = min(kDaTile, g.kp - kt * kDaTile);
    int64_t t = r - kt * tile;
    const int q = static_cast<int>(t & 3);
    t >>= 2;
    const int c = static_cast<int>(t % w);
    t /= w;
    const int half = static_cast<int>(t & 1);
    const int hl = static_cast<int>((t >> 1) & 1);
    const int step = static_cast<int>(t >> 2);
    const int n = step * 8 + half * 4 + q;  // n' = l P + p
    const int l = g.pinv ? __umulhi(static_cast<unsigned>(n), g.pinv) : n;
    const int p = n - l * g.p;
    const int k = kt * kDaTile + c;
    float v = 0.f;
    if (l < g.l && p < g.p && k < g.k) {
      v = g.b[(static_cast<size_t>(p) * g.k + k) * g.l + l];
    }
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    g.bt[r] = __uint_as_float(hl ? lo : hi);
  }
}

// ------------------------------------------------------------------- da

// A block: kDaRows rows from m0, warpgroup wg the 64 from m0 + 64 wg, and
// the 32C columns from k0. The reduction runs over
// n' = l P + p (Bt packed in the same order), so that a thread finds its
// two columns' (p, l) by a multiplication with a reciprocal, and no
// branch. STAGED (L <= kDaGiMaxL): the rows' g, split into hi and lo once,
// and idx wait in shared memory; else each step reads g and idx from
// device memory and splits them. Stage s of Bt (steps 2s and 2s + 1, one
// contiguous run) lands in slot s % 4 by one bulk copy on the tensor
// memory accelerator, two stages ahead; one group of products stays in
// flight across the stages. Each step's g and idx are read while the step
// before runs on the tensor cores; the warpgroups' products share each
// staged step of Bt. Every kDaPromoteSteps steps, once the step's fragment
// is built, the warpgroup drains its products, adds the accumulator into
// its sum, and the step's first product overwrites the accumulator.
template <int C, bool STAGED>
__device__ __forceinline__ void da_block(const Group& g, int local,
                                         float* smem, uint64_t* full) {
  constexpr int W = C * kChunk;
  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kt = local % g.da_ktiles;
  const int m0 = (local / g.da_ktiles) * kDaRows;
  const int k0 = kt * kDaTile;
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool live = m0 + wg * 64 < g.m;  // warpgroup-uniform
  const int stages = g.nsteps / kDaSteps;
  const int rows = min(kDaRows, g.m - m0);

  // g (hi, lo) and idx of the block's rows, [rows][L] each, from row m0.
  float* ghi = smem + kDaRingFloats;
  float* glo = ghi + kDaRows * kDaGiMaxL;
  int* ism = reinterpret_cast<int*>(glo + kDaRows * kDaGiMaxL);
  if (STAGED) {
    const size_t o = static_cast<size_t>(m0) * g.l;
    stage_flat(ghi, g.g + o, rows * g.l, g.g_vec);
    stage_flat(ism, g.idx + o, rows * g.l, g.i_vec);
  }

  // Stage s of the tile, [step][hl][half][W][4], by thread 0.
  const float* tile_bt =
      g.bt + static_cast<size_t>(kt) * g.nsteps * 16 * kDaTile;
  const auto issue = [&](int s) {
    bulk_copy(smem + (s % kDaStages) * kDaStageFloats,
              tile_bt + static_cast<size_t>(s) * kDaSteps * 16 * W,
              kDaSteps * 16 * W * 4, full + s % kDaStages);
  };

  // The thread's rows (+8 i): offsets into g and idx (rows past M read row
  // M - 1 and take idx -1). A step's g (or its hi, lo), idx and the two
  // columns' p (rp; -2 where l is past L) for entry v = i + 2h.
  int roff[2];
  bool rv[2];
  const int row0 = STAGED ? m0 : 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = row + 8 * i;
    rv[i] = m < g.m;
    roff[i] = (min(m, g.m - 1) - row0) * g.l;
  }
  float rg[4], rl[4];
  int ri[4], rp[2];
  const auto load = [&](int step) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = step * 8 + (lane & 3) + 4 * h;
      const int l =
          g.pinv ? __umulhi(static_cast<unsigned>(n), g.pinv) : n;
      rp[h] = l < g.l ? n - l * g.p : -2;
      const int lc = min(l, g.l - 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = roff[i] + lc;
        if (STAGED) {
          rg[i + 2 * h] = ghi[o];
          rl[i + 2 * h] = glo[o];
          ri[i + 2 * h] = rv[i] ? ism[o] : -1;
        } else {
          rg[i + 2 * h] = __ldg(g.g + o);
          ri[i + 2 * h] = rv[i] ? __ldg(g.idx + o) : -1;
        }
      }
    }
  };
  // The loaded step's fragment: S = g where idx is the column's p.
  const auto fragment = [&](uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const bool on = ri[v] == rp[v >> 1];
      if (STAGED) {
        hi[v] = on ? __float_as_uint(rg[v]) : 0u;
        lo[v] = on ? __float_as_uint(rl[v]) : 0u;
      } else {
        split_tf32(on ? rg[v] : 0.f, hi[v], lo[v]);
      }
    }
  };

  float acc[16 * C], sum[16 * C];
#pragma unroll
  for (int j = 0; j < 16 * C; ++j) acc[j] = sum[j] = 0.f;
  uint32_t fh[2][4], fl[2][4];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDaStages - 2; ++s) {
      if (s < stages) issue(s);
    }
  }
  if (STAGED) {
    cp_async_commit();
    cp_async_wait<0>();  // g and idx are in
    __syncthreads();
    for (int e = tid; e < rows * g.l; e += kDaThreads) {  // g -> hi, lo
      uint32_t hi, lo;
      split_tf32(ghi[e], hi, lo);
      ghi[e] = __uint_as_float(hi);
      glo[e] = __uint_as_float(lo);
    }
    __syncthreads();
  }
  if (live && stages > 0) load(0);
  for (int st = 0; st < stages; ++st) {
    mbar_wait(full + st % kDaStages, (st / kDaStages) & 1);  // stage st
    // Every warpgroup is past stage st - 1 and has at most one group of
    // products in flight: stage st - 2's slot is free.
    __syncthreads();
    if (tid == 0 && st + kDaStages - 2 < stages) {
      issue(st + kDaStages - 2);
    }
    if (live) {
      const float* slot = smem + (st % kDaStages) * kDaStageFloats;
#pragma unroll
      for (int s = 0; s < kDaSteps; ++s) {
        // The products of two steps back, which read these, are done.
        wg_wait<1>();
        keep_frag(fh[s & 1]);
        keep_frag(fl[s & 1]);
        fragment(fh[s & 1], fl[s & 1]);
        // Promotion (a no-op on the zeroed accumulator at step 0); the
        // step's first product then overwrites the accumulator.
        const bool fresh = (st * kDaSteps + s) % kDaPromoteSteps == 0;
        if (fresh) {
          wg_wait<0>();
          keep_acc<C>(acc);
          promote<C>(sum, acc);
        }
        keep_acc<C>(acc);
        wg_fence();
        const float* b = slot + s * 16 * W;
        mma_step<C>(acc, fh[s & 1], fl[s & 1], b, b + 2 * W * 4, W * 16,
                    !fresh);
        wg_commit();
        if (st * kDaSteps + s + 1 < g.nsteps) load(st * kDaSteps + s + 1);
      }
    }
  }
  if (!live) return;
  wg_wait<0>();
  keep_acc<C>(acc);
  promote<C>(sum, acc);
#pragma unroll
  for (int j = 0; j < 4 * C; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row + 8 * i;
      const int k = k0 + j * 8 + 2 * (lane & 3);
      if (m < g.m) {
        float* out = g.da + static_cast<size_t>(m) * g.k + k;
        if (k < g.k) out[0] = sum[4 * j + 2 * i];
        if (k + 1 < g.k) out[1] = sum[4 * j + 2 * i + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kDaThreads, 1)
score_grad_da_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kDaStages];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDaStages; ++s) mbar_init(full + s);
    mbar_fence_init();
  }
  __syncthreads();
  const Group& g = table.g[find_group(table, blockIdx.x, &Group::da_begin)];
  const int local = blockIdx.x - g.da_begin;
  const int k0 = (local % g.da_ktiles) * kDaTile;
  const bool staged = g.l <= kDaGiMaxL;
  with_chunks<kDaMaxChunks>((g.kp - k0) / kChunk, [&](auto c) {
    if (staged) {
      da_block<decltype(c)::value, true>(g, local, smem, full);
    } else {
      da_block<decltype(c)::value, false>(g, local, smem, full);
    }
  });
}

// ------------------------------------------------------------------- db

// Rows m0 .. m0 + 31 of a, columns kb .. kb + 255, into a stage of rows of
// kDbAStride floats, V floats a copy; rows past r1 and columns past K are
// zero-filled.
template <int V>
__device__ __forceinline__ void db_issue(const Group& g, int m0, int r1,
                                         int kb, float* stage) {
  constexpr int kPerRow = kDbK / V;
  for (int e = threadIdx.x; e < kDbRows * kPerRow; e += kDbThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * V;
    const int m = m0 + r;
    const bool ok = m < r1 && kb + c < g.k;
    cp_async<V>(stage + r * kDbAStride + c,
                ok ? g.a + static_cast<size_t>(m) * g.k + kb + c : g.a, ok);
  }
}

// A block: kDbK columns of k from kb (warpgroup wg the 64 from kb + 64 wg),
// the 32C columns of n from n0, and the rows of one
// range, 32 at a time. A chunk's rows of a land in one stage by cp.async.
// While a chunk runs on the tensor cores the threads build the next
// chunk's S in the other buffer, one entry a step (g and idx read a step
// ahead), and the chunk after next is in flight. After every
// kDbPromoteChunks chunks (and the last), with the products drained, the
// accumulator is added into the thread's sum, and the next chunk's first
// product overwrites it.
template <int C>
__device__ __forceinline__ void db_block(const Group& g, int local,
                                         float* smem) {
  constexpr int W = C * kChunk;
  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int nt = local % g.db_ntiles;
  const int kt = (local / g.db_ntiles) % g.db_ktiles;
  const int range = local / (g.db_ntiles * g.db_ktiles);
  const int n0 = nt * kTile;
  const int kb = kt * kDbK;
  const int nq = g.db_nchunks * kChunk;
  const int r0 = range * g.db_rows;
  const int r1 = min(g.m, r0 + g.db_rows);
  const int chunks = (r1 - r0 + kDbRows - 1) / kDbRows;
  const bool live = kb + wg * 64 < g.k;  // warpgroup-uniform

  // Stage c % 3: a [kDbRows][kDbAStride].
  const auto stage_of = [&](int c) {
    return smem + (c % kDbStages) * kDbStageFloats;
  };
  const auto issue = [&](int c) {
    float* stage = stage_of(c);
    const int m0 = r0 + c * kDbRows;
    switch (g.a_vec) {
      case 4: db_issue<4>(g, m0, r1, kb, stage); break;
      case 2: db_issue<2>(g, m0, r1, kb, stage); break;
      default: db_issue<1>(g, m0, r1, kb, stage); break;
    }
  };
  // S buffer `buf`: hi [kDbRows / 4][W][4], then lo; entry (m, n) at
  // ((m / 4) * W + n) * 4 + m % 4.
  const auto s_hi = [&](int buf) {
    return smem + kDbStages * kDbStageFloats + buf * kDbSFloats;
  };

  // Entry j (of kEntries) of a thread: 4 rows of one n, j * kDbThreads + tid
  // = quad * W + n - n0 (none past W * kDbRows / 4). load() reads its g and
  // idx (of chunk c) through L1, store() splits and writes it; both find
  // the entry's n, p and place from j (no registers held between them but
  // the loaded values).
  constexpr int kEntries = (W * kDbRows / 4 + kDbThreads - 1) / kDbThreads;
  static_assert(kEntries <= kDbRows / 8, "one entry of S a step at most");
  float rg[4];
  int ri[4];
  const auto entry_p = [&](int nl) {
    const int n = n0 + nl;
    return g.linv ? static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                              g.linv))
                  : n;
  };
  const auto load = [&](int c, int j) {
    const int m0 = r0 + c * kDbRows;
    const int e = j * kDbThreads + tid;
    if (e >= W * kDbRows / 4) return;
    const int quad = e / W;
    const int nl = e - quad * W;
    const int p = entry_p(nl);
    const int l = n0 + nl - p * g.l;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + quad * 4 + u;
      rg[u] = 0.f;
      ri[u] = -1;
      if (m < r1 && p < g.p) {
        const size_t o = static_cast<size_t>(m) * g.l + l;
        rg[u] = __ldg(g.g + o);
        ri[u] = __ldg(g.idx + o);
      }
    }
  };
  const auto store = [&](int buf, int j) {
    const int e = j * kDbThreads + tid;
    if (e >= W * kDbRows / 4) return;
    const int quad = e / W;
    const int nl = e - quad * W;
    const int p = entry_p(nl);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      split_tf32(ri[u] == p ? rg[u] : 0.f, hi[u], lo[u]);
    }
    float* dst = s_hi(buf) + (quad * W + nl) * 4;
    *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + kDbRows * W) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  };

  // The thread's a^T fragment of step s: rows (of the product) k = kb +
  // 64 wg + 16 warp + lane/4 (+8), columns m = 8s + lane%4 (+4).
  const int kf = wg * 64 + warp * 16 + (lane >> 2);
  const auto fragment = [&](const float* as, int s, uint32_t (&hi)[4],
                            uint32_t (&lo)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = as[(s * 8 + (lane & 3) + 4 * h) * kDbAStride + kf +
                           8 * i];
        split_tf32(v, hi[i + 2 * h], lo[i + 2 * h]);
      }
    }
  };

  float acc[16 * C], sum[16 * C];
#pragma unroll
  for (int j = 0; j < 16 * C; ++j) acc[j] = sum[j] = 0.f;
  constexpr int F = kDbFragments;
  uint32_t fh[F][4], fl[F][4];
  if (chunks > 0) issue(0);
  cp_async_commit();
  if (chunks > 1) issue(1);
  cp_async_commit();
  if (chunks > 0) {
#pragma unroll
    for (int j = 0; j < kEntries; ++j) {
      load(0, j);
      store(0, j);
    }
  }
  cp_async_wait<1>();  // chunk 0 is in
  fence_async_smem();
  __syncthreads();
  for (int t = 0; t < chunks; ++t) {
    // Stage (t + 2) % 3 held chunk t - 1, read by its products: done at the
    // last barrier.
    if (t + 2 < chunks) issue(t + 2);
    cp_async_commit();
    const int buf = t & 1;
    const bool next = t + 1 < chunks;
    if (live) {
      const float* as = stage_of(t);
      const float* sh = s_hi(buf);
#pragma unroll
      for (int s = 0; s < kDbRows / 8; ++s) {
        if (s >= F) {
          wg_wait<F - 1>();
          keep_frag(fh[s % F]);
          keep_frag(fl[s % F]);
        }
        fragment(as, s, fh[s % F], fl[s % F]);
        keep_acc<C>(acc);
        wg_fence();
        // Step s covers rows 8s .. 8s + 7: the quads 2s and 2s + 1.
        mma_step<C>(acc, fh[s % F], fl[s % F], sh + 2 * s * W * 4,
                    sh + kDbRows * W + 2 * s * W * 4, W * 16,
                    s > 0 || t % kDbPromoteChunks != 0);
        wg_commit();
        if (next && s >= 1 && s <= kEntries) store(buf ^ 1, s - 1);
        if (next && s < kEntries) load(t + 1, s);
      }
      wg_wait<0>();
      keep_acc<C>(acc);
      if (!next || (t + 1) % kDbPromoteChunks == 0) promote<C>(sum, acc);
#pragma unroll
      for (int j = 0; j < F; ++j) {
        keep_frag(fh[j]);
        keep_frag(fl[j]);
      }
      if (next && kEntries == kDbRows / 8) store(buf ^ 1, kEntries - 1);
    } else if (next) {
#pragma unroll
      for (int j = 0; j < kEntries; ++j) {
        load(t + 1, j);
        store(buf ^ 1, j);
      }
    }
    cp_async_wait<1>();  // chunk t + 1 is in
    fence_async_smem();
    __syncthreads();  // S of t + 1 built; chunk t's reads done
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = kb + kf + 8 * i;
    if (k < g.k) {
      float* part = g.part + (static_cast<size_t>(range) * g.k + k) * nq +
                    n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 4 * C; ++j) {
        *reinterpret_cast<float2*>(part + j * 8) =
            make_float2(sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kDbThreads, 1)
score_grad_db_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(128) float smem[];
  const Group& g = table.g[find_group(table, blockIdx.x, &Group::db_begin)];
  const int local = blockIdx.x - g.db_begin;
  const int nt = local % g.db_ntiles;
  with_chunks<kMaxChunks>(g.db_nchunks - nt * kMaxChunks, [&](auto c) {
    db_block<decltype(c)::value>(g, local, smem);
  });
}

// db[p, k, l] = the sum over ranges of the partial sums at (k, n = p L +
// l), in a fixed order: eight running sums, range r into sum r % 8 in
// ascending r, then ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)); the
// eight chains keep eight loads in flight. One thread an element, l
// fastest.
__global__ void __launch_bounds__(kThreads)
score_grad_db_sum_kernel(const __grid_constant__ GroupTable table,
                         int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const Group& g = table.g[find_group64(table, e, &Group::sum_begin)];
    int64_t r = e - g.sum_begin;
    const int l = static_cast<int>(r % g.l);
    r /= g.l;
    const int k = static_cast<int>(r % g.k);
    const int p = static_cast<int>(r / g.k);
    const int nq = g.db_nchunks * kChunk;
    const size_t step = static_cast<size_t>(g.k) * nq;
    const float* src = g.part + static_cast<size_t>(k) * nq + p * g.l + l;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int range = 0;
    for (; range + 8 <= g.db_ranges; range += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += src[(range + j) * step];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (range + j < g.db_ranges) acc[j] += src[(range + j) * step];
    }
    g.db[(static_cast<size_t>(p) * g.k + k) * g.l + l] =
        ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
        ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  }
}

int64_t ceil_div(int64_t x, int64_t y) { return (x + y - 1) / y; }

// Floats a copy can move: the widest of 4, 2, 1 that divides the row
// length and the tile's start columns and to whose bytes the base address
// is aligned.
int copy_width(int64_t ptr, int row, int tile_cols) {
  for (int v = 4; v > 1; v /= 2) {
    if (row % v == 0 && tile_cols % v == 0 && ptr % (4 * v) == 0) return v;
  }
  return 1;
}

// Allow da's and db's dynamic shared memory, once per device.
int allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(score_grad_da_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(score_grad_db_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDbSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

int grid_for(int64_t total) {
  return static_cast<int>(std::min<int64_t>(ceil_div(total, kThreads), 4096));
}

}  // namespace

// Fills `table` from the launch arguments (see
// molkgnn_support_score_backward), the packed Bt and the partial sums of
// the groups laid out one after another from `scratch`. Returns -1 for
// arguments the kernels do not take, else 0; sets the blocks of da and db,
// the elements of the packing and summing passes and the floats of
// scratch.
static int plan(int num_groups, const int64_t* args, float* scratch,
                GroupTable& table, int& da_blocks, int& db_blocks,
                int64_t& pack_total, int64_t& sum_total,
                int64_t& scratch_floats) {
  if (num_groups < 1 || num_groups > kMaxGroups) return -1;
  table.count = num_groups;
  da_blocks = db_blocks = 0;
  pack_total = sum_total = scratch_floats = 0;
  int64_t db_work = 0;
  for (int i = 0; i < num_groups; ++i) {
    const int64_t* v = args + 10 * i;
    const int64_t m = v[6], k = v[7], l = v[8], p = v[9];
    if (m < 0 || k < 0 || l < 0 || p < 1) return -1;
    if (m * k > INT32_MAX || m * l > INT32_MAX || p * l > INT32_MAX ||
        p * k * l > INT32_MAX || k > INT32_MAX - kDaTile) {
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
    g.n = static_cast<int>(p * l);
    // n' < 2^20: (n' * pinv) >> 32 = n' / P exactly (pinv P - 2^32 < P).
    if (p * l >= (int64_t{1} << 20) - 64) return -1;
    g.pinv = p == 1 ? 0u
                    : static_cast<unsigned>((int64_t{1} << 32) / p + 1);
    g.linv = l <= 1 ? 0u
                    : static_cast<unsigned>((int64_t{1} << 32) / l + 1);
    g.nsteps = static_cast<int>(ceil_div(ceil_div(g.n, 8), kDaSteps) *
                                kDaSteps);
    g.g_vec = copy_width(v[2], 4, 4);
    g.i_vec = copy_width(v[3], 4, 4);
    g.kp = static_cast<int>(ceil_div(k, kChunk) * kChunk);

    // da: Bt packed once; blocks of kDaRows rows x kDaTile columns.
    g.bt = nullptr;
    g.pack_begin = pack_total;
    g.da_ktiles =
        static_cast<int>(std::max<int64_t>(1, ceil_div(g.kp, kDaTile)));
    g.da_begin = da_blocks;
    g.da_blocks = 0;
    if (g.da != nullptr && m > 0 && k > 0) {
      const int64_t floats = static_cast<int64_t>(g.nsteps) * 16 * g.kp;
      if (floats > INT32_MAX) return -1;
      g.bt = scratch == nullptr ? nullptr : scratch + scratch_floats;
      scratch_floats += floats;
      pack_total += floats;
      g.da_blocks = static_cast<int>(g.da_ktiles * ceil_div(m, kDaRows));
    }
    da_blocks += g.da_blocks;

    // db: tiles of 256 k x 128 n; ranges of 32-row chunks below.
    g.db_ktiles = static_cast<int>(ceil_div(k, kDbK));
    g.db_nchunks = static_cast<int>(ceil_div(g.n, kChunk));
    g.db_ntiles = static_cast<int>(ceil_div(g.db_nchunks, kMaxChunks));
    g.a_vec = copy_width(v[0], g.k, kDbK);
    g.db_blocks = 0;
    g.db_ranges = 0;
    g.db_rows = kDbRows;
    g.part = nullptr;
    g.sum_begin = sum_total;
    if (g.db != nullptr) {
      if (m > 0 && k > 0 && g.n > 0) {
        db_work += static_cast<int64_t>(g.db_ktiles) * g.db_nchunks *
                   ceil_div(m, kDbRows);
      }
      sum_total += p * k * l;
    }
  }
  // db's ranges: about kDbBlocks blocks in all, shared out by the groups'
  // work (tiles x chunks of 32 columns of n x chunks of rows); each range's
  // partial sums [ranges][K][32 db_nchunks] in scratch.
  for (int i = 0; i < num_groups; ++i) {
    Group& g = table.g[i];
    g.db_begin = db_blocks;
    if (g.db == nullptr || g.m == 0 || g.k == 0 || g.n == 0) continue;
    const int64_t tiles = static_cast<int64_t>(g.db_ktiles) * g.db_ntiles;
    const int64_t chunks = ceil_div(g.m, kDbRows);
    const int64_t work = static_cast<int64_t>(g.db_ktiles) * g.db_nchunks *
                         chunks;
    const int64_t target = std::max<int64_t>(1, kDbBlocks * work / db_work);
    // At most 32 kDbRangeChunks P rows a range: more blocks where P is
    // small (see kDbRangeChunks).
    const int64_t ranges = std::min<int64_t>(
        chunks,
        std::max({ceil_div(target, tiles),
                  ceil_div(chunks, int64_t{kDbRangeChunks} * g.p),
                  int64_t{1}}));
    g.db_rows = static_cast<int>(ceil_div(chunks, ranges) * kDbRows);
    g.db_ranges = static_cast<int>(ceil_div(g.m, g.db_rows));
    g.db_blocks = static_cast<int>(tiles * g.db_ranges);
    g.part = scratch == nullptr ? nullptr : scratch + scratch_floats;
    scratch_floats += static_cast<int64_t>(g.db_ranges) * g.k *
                      g.db_nchunks * kChunk;
    db_blocks += g.db_blocks;
  }
  return 0;
}

extern "C" {

// Floats of scratch that molkgnn_support_score_backward needs for these
// groups (the packed Bt and db's partial sums), or -1 for arguments it
// does not take.
int64_t molkgnn_support_score_backward_scratch(int num_groups,
                                               const int64_t* args) {
  GroupTable table;
  int da_blocks, db_blocks;
  int64_t pack_total, sum_total, scratch_floats;
  if (plan(num_groups, args, nullptr, table, da_blocks, db_blocks,
           pack_total, sum_total, scratch_floats) != 0) {
    return -1;
  }
  return scratch_floats;
}

// The scorer's backward for `num_groups` groups on `stream`. `args` holds 10
// values a group, in the order the blocks are to be laid out: a, b, g, idx,
// da, db (device addresses; da or db 0 where that gradient is not wanted),
// then M, K, L, P. `scratch` (16-byte aligned, `scratch_floats` long) takes
// the packed Bt and db's partial sums. Returns 0, a cudaError_t, or -1 for
// arguments the kernels do not take (too many groups, P < 1, negative
// sizes, sizes past int32, too little or misaligned scratch).
int molkgnn_support_score_backward(int num_groups, const int64_t* args,
                                   float* scratch, int64_t scratch_floats,
                                   void* stream) {
  GroupTable table;
  int da_blocks, db_blocks;
  int64_t pack_total, sum_total, need;
  if (plan(num_groups, args, scratch, table, da_blocks, db_blocks,
           pack_total, sum_total, need) != 0) {
    return -1;
  }
  if (need > scratch_floats ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return -1;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (da_blocks > 0 || db_blocks > 0) {
    const int err = allow_smem();
    if (err != 0) return err;
  }
  if (pack_total > 0) {
    score_grad_pack_kernel<<<grid_for(pack_total), kThreads, 0, s>>>(
        table, pack_total);
  }
  if (da_blocks > 0) {
    score_grad_da_kernel<<<da_blocks, kDaThreads, kDaSmem, s>>>(table);
  }
  if (db_blocks > 0) {
    score_grad_db_kernel<<<db_blocks, kDbThreads, kDbSmem, s>>>(table);
  }
  if (sum_total > 0) {
    score_grad_db_sum_kernel<<<grid_for(sum_total), kThreads, 0, s>>>(
        table, sum_total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the four kernels (pack, da, db, db_sum) on the current
// device: registers a thread, static shared memory (bytes), local memory a
// thread (bytes, spills) and resident blocks per SM at the dynamic shared
// memory each takes. Fills out[4 * 4]; returns 0 or a cudaError_t.
int molkgnn_support_score_backward_facts(int* out) {
  int err = allow_smem();
  if (err != 0) return err;
  const void* kernels[4] = {
      reinterpret_cast<const void*>(score_grad_pack_kernel),
      reinterpret_cast<const void*>(score_grad_da_kernel),
      reinterpret_cast<const void*>(score_grad_db_kernel),
      reinterpret_cast<const void*>(score_grad_db_sum_kernel),
  };
  const int smem[4] = {0, kDaSmem, kDbSmem, 0};
  const int threads[4] = {kThreads, kDaThreads, kDbThreads, kThreads};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes attr;
    err = static_cast<int>(cudaFuncGetAttributes(&attr, kernels[i]));
    if (err != 0) return err;
    int blocks = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernels[i], threads[i], smem[i]));
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

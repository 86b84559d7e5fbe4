// The segment sum's plan, built on an NVIDIA Hopper card (sm_90a): a
// stable counting sort of the terms' segment ids.
//
// Replaces no TPU kernel. The JAX package needs no plan: XLA's
// segment_sum orders its sums itself. The port's fixed-order segment sum
// (csrc/segment_sum.cu) reads a CSR plan, and this kernel builds it in
// place of the plain torch chain of ops/segment.py (a mask, a stable
// torch.sort of int64 ids, searchsorted, a gather and casts).
//
// For E terms with ids[i] in [0, S) and an optional mask and gather:
//   key[i]  = mask[i] ? ids[i] : S        (S: the dump segment)
//   order   = the stable sort of key: each segment's terms in list order
//   row[j]  = gather ? gather[order[j]] : order[j]            int32 [E]
//   rowptr[s] = the number of terms whose key is below s      int32 [S + 2]
//   ids_out[i] = key[i]                                        int64 [E]
// Integer results, exactly those of the plain chain.
//
// What bounds it on this card: bytes and launches. Each pass reads and
// writes every key and payload once (8 bytes a term each way); at the
// flagship's E (up to 85,336) that is well under a microsecond of memory
// time, so the launches and their dependent steps are what cost. There is
// no product, so Hopper's tensor-core paths (wgmma, TMA, clusters) do not
// apply. The design:
//
//   * LSD radix passes over the live bits only: 8-bit digits, keys below
//     2^(8P) in P passes (the host sets P from S: keys <= S need
//     S.bit_length() bits), so 2 passes for S < 65,536, 3 below 2^24,
//     where a sort of int64 keys would take 8.
//   * Each pass: a histogram kernel (per tile of kTile keys, 256 digit
//     counts in shared memory; the first pass's also computes the keys and
//     ids_out from ids and the mask), a scan kernel with a block a digit
//     (its counts over the tiles, and the digit's total), and a stable
//     scatter, whose blocks each scan the 256 digit totals themselves for
//     the digits' starts. Counts are integers: atomics on them are exact
//     and order-free.
//   * The scatter ranks a key among the equal digits of its tile in list
//     order: a warp owns kTile / 8 consecutive keys and takes them 32 at a
//     time, __match_any_sync groups a round's equal digits, a key's rank is
//     the count of its group's lanes below it plus the warp's running count
//     of the digit (shared memory, updated by the group's lowest lane);
//     then the 8 warps' counts are scanned in warp order. No placement
//     depends on scheduling. The last pass writes row (gathered).
//   * rowptr: the first pass also counts each key (global integer atomics,
//     one a run of equal keys in a warp, into rowptr zeroed by a memset);
//     pass 0's scan kernel scans it too, in chunks of kChunk, a block each,
//     and pass 0's scatter kernel adds the chunks before to each chunk in
//     blocks past its tiles: rowptr[s] = the terms whose key is below s.
//   * Launch shapes come from E and S alone and scratch from the caller
//     (torch.empty on the current stream): no host synchronisation, so a
//     plan can be built inside a CUDA graph capture.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // rounds of 32 keys a warp takes a tile
constexpr int kTile = kThreads * kRounds;  // keys a tile (block)
constexpr int kDigits = 256;
constexpr int kItems = 8;  // contiguous counts a thread scans at a time
constexpr int kChunk = kThreads * kItems;  // rowptr's counts a scan block

// The exclusive scan of the 256 threads' values v, in thread order; the
// block's total in *total. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;  // inclusive within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  int all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums is free again
  *total = all;
  return before + x - v;
}

// Exclusive scan of data[0, n) in place by one block of 256 threads, each
// kItems contiguous counts at a time; returns the total.
__device__ int block_scan_inplace(int* __restrict__ data, int n) {
  int carry = 0;
  for (int base = 0; base < n; base += kChunk) {
    const int first = base + threadIdx.x * kItems;
    int v[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = first + k < n ? data[first + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive(sum, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) data[first + k] = run;
      run += v[k];
    }
    carry += total;
  }
  return carry;
}

// Pass 0's histogram: the keys, ids_out, each tile's digit counts at
// hist[digit * tiles + tile], and each key's count added to counts[key]
// (zeroed before; one atomic a run of equal keys in a warp).
__global__ void __launch_bounds__(kThreads)
    plan_keys_kernel(const void* __restrict__ ids, int ids64,
                     const unsigned char* __restrict__ mask, int E, int S,
                     int* __restrict__ keys, int64_t* __restrict__ ids_out,
                     int* __restrict__ hist, int tiles,
                     int* __restrict__ key_counts) {
  __shared__ int counts[kDigits];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    int key = -1;  // no key: past the end
    if (i < E) {
      key = ids64 ? static_cast<int>(static_cast<const int64_t*>(ids)[i])
                  : static_cast<const int*>(ids)[i];
      if (mask != nullptr && !mask[i]) key = S;
      keys[i] = key;
      ids_out[i] = key;
      atomicAdd(&counts[key & (kDigits - 1)], 1);
    }
    const unsigned same = __match_any_sync(0xffffffffu, key);
    // Ids outside [0, S) are the caller's fault; they are not counted.
    if (i < E && lane == __ffs(same) - 1 &&
        static_cast<unsigned>(key) <= static_cast<unsigned>(S)) {
      atomicAdd(&key_counts[key], __popc(same));
    }
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = counts[threadIdx.x];
}

// A later pass's histogram of digit (key >> shift) & 255.
__global__ void __launch_bounds__(kThreads)
    plan_hist_kernel(const int* __restrict__ keys, int E, int shift,
                     int* __restrict__ hist, int tiles) {
  __shared__ int counts[kDigits];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    if (i < E) atomicAdd(&counts[(keys[i] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = counts[threadIdx.x];
}

// Block d < 256: the exclusive scan in place of digit d's counts over the
// tiles (hist[d * tiles, (d + 1) * tiles)), and their total in
// digit_total[d]. Block 256 + c (pass 0): the exclusive scan in place of
// rowptr's chunk c of counts (kChunk of them), its total in chunk_total[c];
// pass 0's scatter adds the chunks before it.
__global__ void __launch_bounds__(kThreads)
    plan_scan_kernel(int* __restrict__ hist, int tiles,
                     int* __restrict__ digit_total, int* __restrict__ rowptr,
                     int bounds, int* __restrict__ chunk_total) {
  int total;
  if (blockIdx.x < kDigits) {
    total = block_scan_inplace(hist + blockIdx.x * tiles, tiles);
    if (threadIdx.x == 0) digit_total[blockIdx.x] = total;
  } else {
    const int c = blockIdx.x - kDigits;
    total = block_scan_inplace(rowptr + c * kChunk,
                               min(kChunk, bounds - c * kChunk));
    if (threadIdx.x == 0) chunk_total[c] = total;
  }
}

// rowptr's chunk c (c >= 1) plus the totals of the chunks before it.
__device__ void rowptr_fixup(int* __restrict__ rowptr, int bounds,
                             const int* __restrict__ chunk_total, int c) {
  int mine = 0;
  for (int j = threadIdx.x; j < c; j += kThreads) mine += chunk_total[j];
  int before;
  block_exclusive(mine, &before);
  const int first = c * kChunk + threadIdx.x * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + k < bounds) rowptr[first + k] += before;
  }
}

// One pass's stable scatter of (key, payload) by digit (key >> shift) &
// 255 to the digit's start (the totals of the digits below it, scanned
// here) plus offsets[digit * tiles + tile] (the digit's count in the tiles
// before, scanned) plus the key's rank among its tile's equal digits in
// list order. vals_in null: the payload is the
// key's position (pass 0). The last pass (row != null) writes row =
// gather[payload] (or the payload) alone.
__global__ void __launch_bounds__(kThreads)
    plan_scatter_kernel(const int* __restrict__ keys_in,
                        const int* __restrict__ vals_in, int E, int shift,
                        const int* __restrict__ offsets,
                        const int* __restrict__ digit_total, int tiles,
                        int* __restrict__ keys_out,
                        int* __restrict__ vals_out, int* __restrict__ row,
                        const void* __restrict__ gather, int gather64,
                        int* __restrict__ rowptr, int bounds,
                        const int* __restrict__ chunk_total) {
  if (blockIdx.x >= tiles) {  // pass 0's blocks past the tiles: rowptr
    rowptr_fixup(rowptr, bounds, chunk_total, blockIdx.x - tiles + 1);
    return;
  }
  __shared__ int warp_counts[kWarps][kDigits];
  __shared__ int tile_offsets[kDigits];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_counts[w][threadIdx.x] = 0;
  {  // the digit's start (the digits below it), then this tile's place
    int unused;
    const int start = block_exclusive(digit_total[threadIdx.x], &unused);
    tile_offsets[threadIdx.x] =
        start + offsets[threadIdx.x * tiles + blockIdx.x];
  }
  __syncthreads();

  // This warp's keys: kRounds rounds of 32 consecutive keys.
  const int base = blockIdx.x * kTile + warp * (32 * kRounds);
  const unsigned below = (1u << lane) - 1u;
  int key[kRounds];
  int val[kRounds];
  int digit[kRounds];
  int local[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {  // every load first
    const int i = base + j * 32 + lane;
    key[j] = i < E ? keys_in[i] : 0;
    val[j] = i < E && vals_in != nullptr ? vals_in[i] : i;
  }
  if (gather != nullptr) {  // the last pass: the rows, read early
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      if (base + j * 32 + lane < E) {
        val[j] = gather64
            ? static_cast<int>(static_cast<const int64_t*>(gather)[val[j]])
            : static_cast<const int*>(gather)[val[j]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const bool valid = base + j * 32 + lane < E;
    // Invalid lanes take digit 256, which no valid lane has.
    digit[j] = valid ? (key[j] >> shift) & (kDigits - 1) : kDigits;
    const unsigned same = __match_any_sync(0xffffffffu, digit[j]);
    int before = 0;
    if (valid) before = warp_counts[warp][digit[j]];
    __syncwarp();
    local[j] = before + __popc(same & below);
    if (valid && lane == __ffs(same) - 1) {
      warp_counts[warp][digit[j]] = before + __popc(same);
    }
    __syncwarp();
  }
  __syncthreads();
  {  // each digit's count in the warps before, in warp order
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w][threadIdx.x];
      warp_counts[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = base + j * 32 + lane;
    if (i >= E) continue;
    const int d = digit[j];
    const int pos = tile_offsets[d] + warp_counts[warp][d] + local[j];
    if (row == nullptr) {
      keys_out[pos] = key[j];
      vals_out[pos] = val[j];
    } else {
      row[pos] = val[j];
    }
  }
}

}  // namespace

extern "C" {

// The scratch the plan of E terms over S segments needs, in int32s: two
// key and two payload buffers of E, the [256, tiles] counts, the 256 digit
// totals and the totals of rowptr's chunks.
int64_t molkgnn_segment_plan_scratch(int64_t E, int64_t S) {
  const int64_t tiles = (E + kTile - 1) / kTile;
  return 4 * E + kDigits * tiles + kDigits + (S + 2 + kChunk - 1) / kChunk;
}

// The plan of E terms over S segments in `passes` 8-bit passes, on
// `stream`: ids int32 (ids64 0) or int64 (1), mask bool or null, gather
// int32/int64 or null; outputs row [E], rowptr [S + 2] (int32) and ids_out
// [E] (int64); scratch of molkgnn_segment_plan_scratch(E, S) int32s. Returns
// 0, a cudaError_t, or -1 for arguments the kernels do not take.
int molkgnn_segment_plan(const void* ids, int ids64, const void* mask,
                         const void* gather, int gather64, int64_t E,
                         int64_t S, int passes, int* row, int* rowptr,
                         int64_t* ids_out, int* scratch,
                         int64_t scratch_ints, void* stream) {
  if (E < 0 || E > INT_MAX || S < 0 || S > INT_MAX - 2 || passes < 1 ||
      passes > 4 || (passes < 4 && (S >> (8 * passes)) != 0) ||
      scratch_ints < molkgnn_segment_plan_scratch(E, S)) {
    return -1;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int e = static_cast<int>(E);
  const int s = static_cast<int>(S);
  // rowptr first holds each key's count, scanned with pass 0's digits.
  cudaError_t err = cudaMemsetAsync(rowptr, 0, (S + 2) * sizeof(int), st);
  if (err != cudaSuccess || e == 0) return static_cast<int>(err);
  int* keys[2] = {scratch, scratch + E};
  int* vals[2] = {scratch + 2 * E, scratch + 3 * E};
  const int tiles = static_cast<int>((E + kTile - 1) / kTile);
  if (static_cast<int64_t>(kDigits) * tiles > INT_MAX) return -1;
  int* hist = scratch + 4 * E;
  int* digit_total = hist + kDigits * tiles;
  int* chunk_total = digit_total + kDigits;
  const int bounds = s + 2;
  const int chunks = (bounds + kChunk - 1) / kChunk;
  for (int p = 0; p < passes; ++p) {
    if (p == 0) {
      plan_keys_kernel<<<tiles, kThreads, 0, st>>>(
          ids, ids64, static_cast<const unsigned char*>(mask), e, s, keys[0],
          ids_out, hist, tiles, rowptr);
    } else {
      plan_hist_kernel<<<tiles, kThreads, 0, st>>>(keys[p & 1], e, 8 * p,
                                                   hist, tiles);
    }
    plan_scan_kernel<<<kDigits + (p == 0 ? chunks : 0), kThreads, 0, st>>>(
        hist, tiles, digit_total, rowptr, bounds, chunk_total);
    const bool last = p == passes - 1;
    plan_scatter_kernel<<<tiles + (p == 0 ? chunks - 1 : 0), kThreads, 0,
                          st>>>(
        keys[p & 1], p == 0 ? nullptr : vals[p & 1], e, 8 * p, hist,
        digit_total, tiles, keys[(p + 1) & 1],
        last ? nullptr : vals[(p + 1) & 1], last ? row : nullptr,
        last ? gather : nullptr, gather64, rowptr, bounds, chunk_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* molkgnn_segment_plan_error_string(int code) {
  if (code == -1) return "invalid arguments for the segment plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

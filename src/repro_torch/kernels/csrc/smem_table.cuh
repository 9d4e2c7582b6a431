// The block body shared by the WORp summing kernels for Hopper (sm_90a):
// the batched scatter (countsketch_scatter.cu) and the dense segment update
// (countsketch_update.cu).  The two differ only in how a slot gets its key:
// the scatter loads it and skips padding (-1), the dense update computes
// base_keys[b] + i and skips nothing.
//
// Design: one block per (stream, chunk of slots), as kernels/tiling.py's
// table_plan cuts them.  The block zeroes a rows x width float32 table in
// dynamic shared memory, walks its chunk with coalesced loads (thread t
// takes slots begin + t, begin + t + blockDim.x, ...), computes each live
// slot's transform once and adds sign * v' to its bucket of every row with
// a shared-memory atomicAdd, then flushes the table once:
//   * one block per stream (block_ends == nullptr): the block owns its
//     stream's delta and writes every cell with plain coalesced stores,
//     zeros included, so the wrapper allocates the delta with torch.empty
//     and an empty stream still gets its zeros;
//   * several chunks per stream: one global atomicAdd per non-zero cell
//     into a zeroed delta, at most rows x width a block where the global
//     design made rows a slot.  A per-chunk workspace summed by a second
//     pass would do as well; the atomics need no second launch and no
//     workspace, so peak memory stays as it was.
// The scatter combines the lanes of a warp that hold one key before its
// shared-memory atomics (combine_lanes): a Zipf head puts about 18 % of a
// stream's slots on key 0.  Shared-memory atomics, like global ones, sum
// in an order that changes from run to run: the tables match the plain version within float
// tolerance, not bit for bit.  The scatter's deterministic variant
// (det_table_block below, under torch.use_deterministic_algorithms) fixes
// the order: one warp owns each row and walks the slots in order.
//
// Shared memory: rows x width x 4 B, 57,344 B at the defaults (7 x 2048).
// Above 48 KB a block needs the opt-in attribute, which prepare_table_kernel
// sets (with the carveout that gives shared memory the SM's 228 KB).  Each
// block also reserves 1 KB, so 4 blocks of 57 KB fit an SM only if the
// registers allow: 512 threads x 4 blocks need 32 registers a thread or
// fewer, 3 blocks 42 (__launch_bounds__(512, 3) caps them there).  The
// kernels take 31-32 (ptxas), so 4 blocks, 2048 threads, fill an SM (the
// occupancy calculator agrees).  Tables up to 232,448 B (rows 7 with width
// <= 8192)
// fit; a larger table takes the global-atomic kernel of the same source,
// chosen by shape before the launch.
#pragma once
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"

namespace worp {

constexpr int kTableThreads = 512;

struct TableArgs {
  const int32_t* seeds;       // (B,) bucket/sign hash seeds
  const int32_t* tseeds;      // (B,) transform seeds
  const int32_t* lengths;     // (B,) live slots [0, lengths[b])
  const int32_t* block_ends;  // (B,) inclusive prefix sum of chunk counts;
                              // nullptr: one block per stream
  float* delta;               // (B, rows, width)
  int B, n, rows, width, chunk, has_p, scheme;
  float neg_inv_p;
};

// Slot (b, i) of a sparse stream: key and value loaded, key -1 is padding.
// Zipf-headed keys make hot buckets, so a warp combines its lanes that hold
// one key before the shared-memory atomics (combine_lanes).
struct SparseSlots {
  static constexpr bool kCombine = true;
  const int32_t* __restrict__ keys;
  const float* __restrict__ values;
  __device__ __forceinline__ bool operator()(int b, int64_t i, int64_t idx,
                                             uint32_t& key, float& v) const {
    const int32_t k = keys[idx];
    key = static_cast<uint32_t>(k);
    v = values[idx];
    return k != -1;
  }
};

// Slot (b, i) of a dense segment: key base_keys[b] + i (wrapping mod 2^32),
// none is padding, so key 0xFFFFFFFF is sketched.  Distinct keys have no
// hot bucket, so each lane adds on its own.
struct DenseSlots {
  static constexpr bool kCombine = false;
  const float* __restrict__ values;
  const int32_t* __restrict__ base_keys;
  __device__ __forceinline__ bool operator()(int b, int64_t i, int64_t idx,
                                             uint32_t& key, float& v) const {
    key = static_cast<uint32_t>(base_keys[b]) + static_cast<uint32_t>(i);
    v = values[idx];
    return true;
  }
};

// Adds sign * v of one slot to its bucket of every row, one lane at a time
// (the shared-memory float atomicAdd compiles to a load, an add and a
// compare-and-swap retried until no other lane wrote the cell between).
__device__ __forceinline__ void add_rows(float* table, uint32_t key, float v,
                                         uint32_t seed, int rows,
                                         uint32_t width) {
  for (int r = 0; r < rows; ++r) {
    const uint32_t salt = row_salt(seed, static_cast<uint32_t>(r));
    atomicAdd(table + r * width + bucket_hash(key, salt, width),
              sign_hash(key, salt) * v);
  }
}

// Combines the lanes of a warp (all 32 present; `live` false for a lane
// without a slot) that hold the same key, so they hit the same 7 cells:
// __match_any_sync finds them, and the lowest of them sums the others'
// values (shuffled to it in lane order; a butterfly of 5 shuffles where
// the whole warp holds one key).  Returns true for the lanes that then add
// their (summed) value, once per row.  sign_r(key) * sum is the sum of the
// signed terms, regrouped.  Without this, k lanes on one cell retry the
// compare-and-swap k times in turn: a stream of one key took 4.8x the Zipf
// deployment's time (chip_smoke.py's hot-key cell, H100 80GB HBM3,
// 700.00 W); matching cells row by row instead of keys once cost the
// deployment a third more.
__device__ __forceinline__ bool combine_lanes(uint32_t key, bool live,
                                              float& v) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  // a lane without a slot gets a tag that matches no key and no other lane
  const unsigned long long tag =
      live ? key : (1ull << 32) + static_cast<unsigned>(lane);
  const unsigned peers = __match_any_sync(kAll, tag);
  if (__all_sync(kAll, peers == kAll)) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    return lane == 0;
  }
  const bool lead = (peers & ((1u << lane) - 1u)) == 0u;
  unsigned rest = lead ? peers & (peers - 1u) : 0u;  // the other peers
  const unsigned most = __reduce_max_sync(kAll, __popc(peers));
  const float x = v;
  for (unsigned k = 1; k < most; ++k) {
    const float y = __shfl_sync(kAll, x, rest ? __ffs(rest) - 1 : lane);
    if (rest) {
      v += y;
      rest &= rest - 1u;
    }
  }
  return lead && live;
}

template <class Slots>
__device__ __forceinline__ void table_block(const Slots& slots,
                                            const TableArgs& a,
                                            float* table) {
  // the stream and slot range of this block (kernels/tiling.py plan_blocks)
  int b = blockIdx.x;
  int64_t begin = 0;
  if (a.block_ends != nullptr) {
    int lo = 0, hi = a.B - 1;  // the first stream with block_ends[b] > blk
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.block_ends[mid] > static_cast<int>(blockIdx.x)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    b = lo;
    const int first = b == 0 ? 0 : a.block_ends[b - 1];
    begin = static_cast<int64_t>(blockIdx.x - first) * a.chunk;
  }
  const int64_t len = a.lengths[b];
  const int64_t end = begin + a.chunk < len ? begin + a.chunk : len;

  const int cells = a.rows * a.width;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;
  __syncthreads();

  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const int64_t row0 = static_cast<int64_t>(b) * a.n;
  if constexpr (Slots::kCombine) {
    // warp-uniform trip count, so every lane reaches the warp collectives
    const int64_t warp0 = begin + (threadIdx.x & ~31u);
    for (int64_t i0 = warp0; i0 < end; i0 += blockDim.x) {
      const int64_t i = i0 + (threadIdx.x & 31);
      uint32_t key = 0;
      float v = 0.0f;
      const bool live = i < end && slots(b, i, row0 + i, key, v);
      if (live && a.has_p) {
        v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
      }
      if (combine_lanes(key, live, v)) {
        add_rows(table, key, v, seed, a.rows, width);
      }
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
      uint32_t key;
      float v;
      if (!slots(b, i, row0 + i, key, v)) continue;
      if (a.has_p) v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
      add_rows(table, key, v, seed, a.rows, width);
    }
  }
  __syncthreads();

  float* dst = a.delta + static_cast<int64_t>(b) * cells;
  if (a.block_ends == nullptr) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) dst[c] = table[c];
  } else {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const float x = table[c];
      if (x != 0.0f) atomicAdd(dst + c, x);  // NaN != 0: NaN is added too
    }
  }
}

// The deterministic block body of the scatter (kernels/tiling.py
// table_plan "det"): every cell sums its terms in one order fixed by slot
// index, so a launch gives the same bits on every run.  One block per
// stream, one warp per row (warp w takes rows w, w + warps, ...).  The
// block walks its stream in tiles of kDetTile slots:
//   1. all threads stage the tile's keys and transformed values in shared
//      memory, the transform once a slot (a dead slot, past the length or
//      key -1, is staged as key 0xFFFFFFFF, which no live scatter key is);
//   2. each warp walks the tile for each of its rows in slot order, 32
//      slots at a time, lane l on slot j0 + l.  The lanes whose slots fall
//      in one bucket sum their signed values to the lowest of them in lane
//      order (combine_lanes, matched on the bucket), and that lane adds the
//      sum to its cell with a plain load and store: only this warp writes
//      the row, and only one lane a cell per step.
// A cell's value is thus ((0 + group 1) + group 2) + ..., each group's sum
// taken in lane order: fixed by the slots, whatever the timing.  The delta
// is written whole with plain stores, as the one-block-per-stream flush of
// table_block does.  Shared memory: the table plus kDetTile x 8 B (65,536 B
// at 7 x 2048), so 3 blocks of 7 warps an SM.  Each (slot, row) is hashed
// once, as in the atomics variant, but with a third of the threads in
// flight and a match and the shuffles per step: 2.30 ms at the flush
// shape, 20 % of its bound and 3.8x the atomics (chip_smoke.py, H100 80GB
// HBM3, 700.00 W).
constexpr int kDetTile = 1024;
constexpr uint32_t kDeadKey = 0xFFFFFFFFu;

__device__ __forceinline__ void det_table_block(const SparseSlots& slots,
                                                const TableArgs& a,
                                                float* table) {
  const int b = blockIdx.x;
  const int64_t len = a.lengths[b];
  const int cells = a.rows * a.width;
  uint32_t* tile_keys = reinterpret_cast<uint32_t*>(table + cells);
  float* tile_vals = reinterpret_cast<float*>(tile_keys + kDetTile);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;

  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const int64_t row0 = static_cast<int64_t>(b) * a.n;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warps = static_cast<int>(blockDim.x >> 5);
  for (int64_t t0 = 0; t0 < len; t0 += kDetTile) {
    const int tile =
        static_cast<int>(len - t0 < kDetTile ? len - t0 : kDetTile);
    __syncthreads();  // the zeroed table, or the previous tile's walk
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      const int64_t i = t0 + j;
      uint32_t key = kDeadKey;
      float v = 0.0f;
      if (slots(b, i, row0 + i, key, v)) {
        if (a.has_p) {
          v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
        }
      } else {
        key = kDeadKey;
        v = 0.0f;
      }
      tile_keys[j] = key;
      tile_vals[j] = v;
    }
    __syncthreads();
    // warp-uniform trip counts, so every lane reaches the warp collectives
    for (int r = warp; r < a.rows; r += warps) {
      const uint32_t salt = row_salt(seed, static_cast<uint32_t>(r));
      float* row = table + static_cast<int64_t>(r) * a.width;
      for (int j0 = 0; j0 < tile; j0 += 32) {
        const int j = j0 + lane;
        const uint32_t key = j < tile ? tile_keys[j] : kDeadKey;
        const bool live = key != kDeadKey;
        uint32_t bucket = 0;
        float v = 0.0f;
        if (live) {
          bucket = bucket_hash(key, salt, width);
          v = sign_hash(key, salt) * tile_vals[j];
        }
        if (combine_lanes(bucket, live, v)) row[bucket] += v;
        __syncwarp();  // this step's stores before the next step's loads
      }
    }
  }
  __syncthreads();

  float* dst = a.delta + static_cast<int64_t>(b) * cells;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) dst[c] = table[c];
}

// Opt a table kernel in to `smem_bytes` of dynamic shared memory (and the
// carveout that gives shared memory the most of the SM).  Returns a CUDA
// error code (0 on success).
template <class Kernel>
int prepare_table_kernel(Kernel* kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

}  // namespace worp

// The block bodies shared by the WORp summing kernels for Hopper (sm_90a):
// the batched scatter (countsketch_scatter.cu) and the dense segment update
// (countsketch_update.cu): the shared-memory atomics body, which the two
// share, and a deterministic body each.  The two kernels differ only in how
// a slot gets its key: the scatter loads it and skips padding (-1), the
// dense update computes base_keys[b] + i and skips nothing.
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
// the order: producer warps hash a stage of slots once, and one warp a row
// then adds the staged terms to its row in slot order.  The dense update's
// deterministic variant (det_dense_block) keeps that order with a warp a
// row that hashes its own row.  A det table too large for one block is
// spread over a thread block cluster (det_cluster_block), each CTA a
// slice of it, the slots hashed once a cluster; past what a cluster
// holds, over blocks that each hash every slot (det_part).
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
#include "kernel_info.cuh"

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
  // the det kernels' split of a table too large for one block
  // (kernels/tiling.py det_split): row_group rows a block (0: all), or,
  // where ranges > 1, one bucket range of one row a block
  int row_group, ranges;
  // (B,) where each dense stream starts in a packed values vector (the
  // update's packed entries); nullptr: stream b starts at b * n
  const int64_t* offsets;
};

// Where stream b's slot 0 lies in the values (and a sparse stream's keys).
__device__ __forceinline__ int64_t stream_start(const TableArgs& a, int b) {
  return a.offsets != nullptr ? a.offsets[b] : static_cast<int64_t>(b) * a.n;
}

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

// The live lanes of one match set (`peers`, from __match_any_sync; a dead
// lane's tag matches no live lane's) sum their v in lane order to the lowest
// of them: v_lead = ((v_1 + v_2) + v_3) + ...  Returns true for the live
// leads.  Every lane of the warp calls it.
__device__ __forceinline__ bool ordered_combine(unsigned peers, bool live,
                                                float& v) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const bool lead = live && (peers & ((1u << lane) - 1u)) == 0u;
  unsigned rest = lead ? peers & (peers - 1u) : 0u;  // the other peers
  const unsigned most =
      __reduce_max_sync(kAll, lead ? static_cast<unsigned>(__popc(peers)) : 0u);
  const float x = v;
  for (unsigned k = 1; k < most; ++k) {
    const float y = __shfl_sync(kAll, x, rest ? __ffs(rest) - 1 : lane);
    if (rest) {
      v = __fadd_rn(v, y);
      rest &= rest - 1u;
    }
  }
  return lead;
}

// Combines the lanes of a warp (all 32 present; `live` false for a lane
// without a slot) that hold the same key, so they hit the same 7 cells:
// __match_any_sync finds them, and the lowest of them sums the others'
// values (shuffled to it in lane order by ordered_combine; a butterfly of
// 5 shuffles where the whole warp holds one key).  Returns true for the
// lanes that then add their (summed) value, once per row.  sign_r(key) *
// sum is the sum of the signed terms, regrouped.  Without this, k lanes on
// one cell retry the compare-and-swap k times in turn: a stream of one key
// took 4.8x the Zipf deployment's time (chip_smoke.py's hot-key cell, H100
// 80GB HBM3, 700.00 W); matching cells row by row instead of keys once
// cost the deployment a third more.
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
  return ordered_combine(peers, live, v);
}

// The stream b and slot range [begin, end) of block `blk` (kernels/tiling.py
// plan_blocks): with block_ends, the chunk of `chunk` slots that the binary
// search over the chunk counts finds; without, the whole stream blk (cut
// at `chunk` where it is positive).
__device__ __forceinline__ void block_range(const TableArgs& a, int blk,
                                            int& b, int64_t& begin,
                                            int64_t& end) {
  b = blk;
  begin = 0;
  if (a.block_ends != nullptr) {
    int lo = 0, hi = a.B - 1;  // the first stream with block_ends[b] > blk
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.block_ends[mid] > blk) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    b = lo;
    const int first = b == 0 ? 0 : a.block_ends[b - 1];
    begin = static_cast<int64_t>(blk - first) * a.chunk;
  }
  const int64_t len = a.lengths[b];
  end = a.chunk > 0 && begin + a.chunk < len ? begin + a.chunk : len;
}

template <class Slots>
__device__ __forceinline__ void table_block(const Slots& slots,
                                            const TableArgs& a,
                                            float* table) {
  int b;
  int64_t begin, end;
  block_range(a, static_cast<int>(blockIdx.x), b, begin, end);

  const int cells = a.rows * a.width;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;
  __syncthreads();

  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const int64_t row0 = stream_start(a, b);
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

// ---------------------------------------------------------------------------
// The deterministic block body of the scatter (kernels/tiling.py table_plan
// "det", under torch.use_deterministic_algorithms): every cell sums its
// terms in one order fixed by the slot indices and the shape alone, so a
// launch gives the same bits on every run, whatever the timing, the SM
// count or the blocks resident.
//
// The order.  A stream's slots fall in groups of 32 (slots 32g .. 32g + 31,
// counted from slot 0); a slot is dead past the stream's length or at key
// -1.  In each group the live slots of one key sum their transformed values
// in slot order to the lowest of them, its lead: c = ((v1 + v2) + v3) + ...
// In each row, the leads whose distinct keys fall in one bucket sum their
// signed sums sign * c (exact: the sign is +-1) in slot order to the lowest
// of them, d = (t1 + t2) + ..., and the cell then takes cell + d.  Groups
// add in slot order, each cell from 0.0f.  kernels/ref.py
// countsketch_scatter_det_ref is this order in plain PyTorch, and the card
// tests hold the kernel to it bit for bit.
//
// The design.  One block per stream, warp-specialised: 8 producer warps
// and one row-walker warp a row (at most 8; walker w takes rows w, w + 8, ...),
// over a double-buffered stage of kDetStage = 256 slots in shared memory
// beside the table:
//   * producer warp g takes group g of each stage (its next key and value
//     loaded one stage ahead, into registers).  Its lanes compute the
//     transform once a slot, match equal keys (__match_any_sync, once a
//     group, not once a row), sum each key's values to its lead in lane
//     order (ordered_combine), and stage the lead's sum, a live mask of the
//     leads, and for every row the lead's bucket and sign, packed in 16 bits
//     (bucket | sign << 15) where width <= 2**15, else 32.  All the hashing,
//     the issue-bound part, runs here, on 8 warps, off the ordered walk.
//   * walker warp w adds stage t to its rows while the producers hash stage
//     t + 1: per group and row, lane l takes its entry and value (the
//     stage's row loaded ahead into registers), reads its cell, marks it
//     with its lane's tag and reads the mark back.
//     Where every lead reads its own tag, no two distinct keys share a
//     bucket, and each adds its value to the cell it read, a plain store
//     (only this warp writes the row, no two lanes one cell).  Where one
//     reads another's tag, the warp matches the buckets and sums each to
//     its lowest lane in lane order first.  With the keys combined, k
//     distinct keys collide in about k(k-1)/2 / width of the (group, row)
//     steps.  The tag needs no shared memory of its own, and in trials on
//     the card it beat both a 2048-bit map a walker (shared-memory
//     atomicOr, then a clear) and a __match_any_sync a step.
//   * named barriers hand the stages over (bar.arrive / bar.sync with the
//     block's thread count): kBarFull + s when producers have filled stage
//     s, kBarFree + s when the walkers are done with it, so stage t + 1 is
//     hashed while stage t is walked, with no __syncthreads in the loop
//     (three or four stages were no faster than two in trials).
// The delta is written whole with plain stores, as the one-block-per-stream
// flush of table_block does.
//
// Budget at the defaults (rows 7, width 2048): the table 57,344 B and two
// stages of 256 x (4 B value + 7 x 2 B entries) + 8 masks, 9,280 B: 66,624
// B a block, so 3 blocks of 15 warps (480 threads) an SM: 45 warps, where
// the design this replaced had 21, at 40 registers a thread
// (__launch_bounds__(512, 3); chip_smoke.py's [occupancy] line prints what
// ptxas gave).  Bound: the hashing, some 360 32-bit operations a live slot
// (chip_smoke.py SCATTER_OPS_PER_SLOT): 0.449 ms at the flush shape (B =
// 4096 x n = 5120) on an H100.  Measured there, over two runs of the
// final tree: 0.890-0.891 ms, half the bound, 1.42-1.46x the atomics
// variant timed in the same run; 6.53-6.77 ms at the TV cascade's 32,768
// streams, 1.45-1.49x (chip_smoke.py, H100 80GB HBM3, 700.00 W; the
// design this replaced: 2.30 ms, 3.76x).  The producers'
// hashing sets the time, and the slowest of a stage's 8 producer warps
// paces each stage.
constexpr int kDetStage = 256;              // slots a stage
constexpr int kDetGroups = kDetStage / 32;  // 32-slot groups a stage
constexpr int kDetProducers = kDetGroups;   // one producer warp a group
constexpr int kDetMaxWalkers = 8;           // row-walker warps at most
constexpr int kBarFull = 1;                 // named barriers 1, 2: full
constexpr int kBarFree = 3;                 // 3, 4: free (0: __syncthreads)
constexpr uint32_t kDeadKey = 0xFFFFFFFFu;  // key -1: padding
constexpr uint32_t kTag = 0xFFC00000u;      // | lane: a lane's mark

// Bytes of one stage: the values, the live masks and rows x kDetStage
// entries of `entry_bytes` each.  A det block's shared memory is the table
// and two stages, in that order (kernels/tiling.py det_smem_bytes).
__host__ __device__ constexpr int det_stage_bytes(int rows, int entry_bytes) {
  return kDetStage * 4 + kDetGroups * 4 + rows * kDetStage * entry_bytes;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One det stage in shared memory.
template <class Entry>
struct DetStage {
  float* vals;     // kDetStage: a lead's sum of its key's values
  uint32_t* live;  // kDetGroups: the leads of each group, a bit a lane
  Entry* ent;      // rows x kDetStage: bucket | sign << (bits - 1)

  __device__ __forceinline__ DetStage(float* stages, int rows, int s) {
    char* base = reinterpret_cast<char*>(stages) +
                 s * det_stage_bytes(rows, static_cast<int>(sizeof(Entry)));
    vals = reinterpret_cast<float*>(base);
    live = reinterpret_cast<uint32_t*>(vals + kDetStage);
    ent = reinterpret_cast<Entry*>(live + kDetGroups);
  }
};

// The part of the table a det block owns (kernels/tiling.py det_cuts and
// det_plan_blocks): block g serves part g % parts of stream or chunk g /
// parts; a part is rows [r0, r1) whole (kDetRows: row groups of row_group
// rows), or buckets [w0, w0 + wn) of row r0 (kDetRanges: `ranges` equal
// ranges of `span` buckets, the last narrower).  A block that holds the
// whole table (kDetWhole) is its stream's or chunk's one part, all of it
// from the kernel's arguments, so its kernel is the unsplit one.  Its
// shared table holds its rows' slices, `wn` floats a row, and the stages
// follow `srows` x `span` floats of it (tiling's smem bytes).
constexpr int kDetWhole = 0;
constexpr int kDetRows = 1;
constexpr int kDetRanges = 2;

struct DetPart {
  int blk;     // the stream (scatter) or chunk (dense update) block
  int r0, r1;  // its rows
  int w0, wn;  // its buckets of each
  int srows, span;
};

template <int kSplit>
__device__ __forceinline__ DetPart det_part(const TableArgs& a) {
  DetPart d;
  const int g = static_cast<int>(blockIdx.x);
  if constexpr (kSplit == kDetWhole) {
    d.blk = g;
    d.r0 = 0;
    d.r1 = a.rows;
    d.w0 = 0;
    d.wn = a.width;
    d.srows = a.rows;
    d.span = a.width;
  } else if constexpr (kSplit == kDetRows) {
    const int parts = (a.rows + a.row_group - 1) / a.row_group;
    d.blk = g / parts;
    d.r0 = (g - d.blk * parts) * a.row_group;
    d.r1 = d.r0 + a.row_group < a.rows ? d.r0 + a.row_group : a.rows;
    d.w0 = 0;
    d.wn = a.width;
    d.srows = a.row_group;
    d.span = a.width;
  } else {
    const int part = g % (a.rows * a.ranges);
    d.blk = g / (a.rows * a.ranges);
    d.span = (a.width + a.ranges - 1) / a.ranges;
    d.srows = 1;
    d.r0 = part / a.ranges;
    d.r1 = d.r0 + 1;
    d.w0 = (part % a.ranges) * d.span;
    d.wn = a.width - d.w0 < d.span ? a.width - d.w0 : d.span;
  }
  return d;
}

// Writes a det block's table (its rows' slices, d.wn floats each) to its
// place in the (.., rows, width) output at row `out`: whole rows are one
// contiguous run of the output, a bucket range one run a row.
__device__ __forceinline__ void det_flush(const TableArgs& a,
                                          const DetPart& d, int64_t out,
                                          const float* table) {
  float* dst = a.delta + (out * a.rows + d.r0) * a.width + d.w0;
  const int cells = (d.r1 - d.r0) * d.wn;
  if (d.wn == a.width) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) dst[c] = table[c];
  } else {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int r = c / d.wn;
      dst[static_cast<int64_t>(r) * a.width + (c - r * d.wn)] = table[c];
    }
  }
}

// kSplit (DetPart): kDetRanges, the block owns a bucket range of one row,
// and a lead whose bucket falls outside it is dead for this block.
template <class Slots, class Entry, int kSplit>
__device__ __forceinline__ void det_produce(const Slots& slots,
                                            const TableArgs& a,
                                            const DetPart& d, float* stages,
                                            int b, int64_t begin, int64_t end,
                                            int tiles) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int kShift = 8 * static_cast<int>(sizeof(Entry)) - 1;
  const int g = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int threads = static_cast<int>(blockDim.x);
  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const int nrows = d.r1 - d.r0;
  const int64_t row0 = stream_start(a, b);
  const int j = g * 32 + lane;  // this lane's slot in every stage
  // this lane's next two slots, loaded two stages ahead (key -1 loads as
  // kDeadKey too)
  uint32_t key1 = kDeadKey, key2 = kDeadKey;
  float v1 = 0.0f, v2 = 0.0f;
  int64_t i = begin + j;  // this lane's slot of stage t
  if (i < end) slots(b, i, row0 + i, key1, v1);
  if (i + kDetStage < end) {
    slots(b, i + kDetStage, row0 + i + kDetStage, key2, v2);
  }
  for (int t = 0; t < tiles; ++t, i += kDetStage) {
    const uint32_t key = key1;
    float v = v1;
    key1 = key2;
    v1 = v2;
    key2 = kDeadKey;
    const int64_t ahead = i + 2 * kDetStage;
    if (ahead < end) slots(b, ahead, row0 + ahead, key2, v2);
    // a sparse slot is dead past the end or at key -1 (both kDeadKey here),
    // a dense one past the end only: its key 0xFFFFFFFF is live
    const bool live = Slots::kCombine ? key != kDeadKey : i < end;
    if (live && a.has_p) {
      v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
    }
    // a group's slots of one key sum to their lead; dense keys are
    // distinct, so each live dense slot is its own lead
    bool lead = Slots::kCombine
                    ? ordered_combine(__match_any_sync(kAll, key), live, v)
                    : live;
    if constexpr (kSplit == kDetRanges) {  // the lead's bucket, its one row
      const uint32_t bucket = bucket_hash(
          key, row_salt(seed, static_cast<uint32_t>(d.r0)), width);
      lead = lead && bucket - static_cast<uint32_t>(d.w0) <
                         static_cast<uint32_t>(d.wn);
    }
    const unsigned leads = __ballot_sync(kAll, lead);
    const int s = t & 1;
    if (t >= 2) named_sync(kBarFree + s, threads);  // stage t - 2 walked
    const DetStage<Entry> st(stages, d.srows, s);
    st.vals[j] = v;
    if (lane == 0) st.live[g] = leads;
    // branch-free and unrolled, so that rows' hash chains interleave
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      const uint32_t salt = row_salt(seed, static_cast<uint32_t>(d.r0 + r));
      uint32_t bucket = bucket_hash(key, salt, width);
      if constexpr (kSplit == kDetRanges) {
        bucket -= static_cast<uint32_t>(d.w0);
      }
      const uint32_t e = bucket | (sign_bit(key, salt) << kShift);
      st.ent[r * kDetStage + j] = static_cast<Entry>(lead ? e : 0u);
    }
    named_arrive(kBarFull + s, threads);
  }
}

template <class Entry>
__device__ __forceinline__ void det_walk(const TableArgs& a,
                                         const DetPart& d, float* table,
                                         float* stages, int walker,
                                         int walkers, int tiles) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int kShift = 8 * static_cast<int>(sizeof(Entry)) - 1;
  constexpr uint32_t kBucket = (1u << kShift) - 1u;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int threads = static_cast<int>(blockDim.x);
  const int nrows = d.r1 - d.r0;
  const uint32_t tag = kTag | static_cast<uint32_t>(lane);
  for (int t = 0; t < tiles; ++t) {
    const int s = t & 1;
    named_sync(kBarFull + s, threads);  // stage t hashed
    const DetStage<Entry> st(stages, d.srows, s);
    for (int r = walker; r < nrows; r += walkers) {
      float* row = table + static_cast<int64_t>(r) * d.wn;
      const Entry* ent = st.ent + r * kDetStage;
      // the stage's row, loaded ahead of the ordered adds
      unsigned leads[kDetGroups];
      uint32_t ents[kDetGroups];
      float vals[kDetGroups];
#pragma unroll
      for (int g = 0; g < kDetGroups; ++g) {
        leads[g] = st.live[g];
        ents[g] = ent[g * 32 + lane];
        vals[g] = st.vals[g * 32 + lane];
      }
#pragma unroll
      for (int g = 0; g < kDetGroups; ++g) {
        if (leads[g] == 0u) continue;  // warp-uniform
        const bool live = (leads[g] >> lane) & 1u;
        const uint32_t bucket = ents[g] & kBucket;
        const float v = (ents[g] >> kShift) ? -vals[g] : vals[g];
        float* cell = row + bucket;
        // each lead reads its cell, then marks it with its lane's tag: a
        // lead that reads back another lane's tag shares its bucket
        const float old = live ? *cell : 0.0f;
        __syncwarp();
        if (live) *cell = __uint_as_float(tag);
        __syncwarp();
        const bool shared = live && __float_as_uint(*cell) != tag;
        if (__any_sync(kAll, shared)) {  // two distinct keys, one bucket
          float sum = v;
          const unsigned peers =
              __match_any_sync(kAll, live ? bucket : 0x80000000u | lane);
          if (ordered_combine(peers, live, sum)) *cell = __fadd_rn(old, sum);
        } else if (live) {
          *cell = __fadd_rn(old, v);
        }
        __syncwarp();  // this group's adds before the next group's reads
      }
    }
    if (t + 2 < tiles) named_arrive(kBarFree + s, threads);
  }
}

// The block takes its range as table_block does: the scatter's det launch
// gives each stream one block (block_ends null, chunk 0), or, for a table
// too large for a block, one block a part of it (det_part: a row group, or
// a bucket range of one row), and the block writes its part of delta row
// b.  The producers of every part load, transform and match every slot of
// the stream; they stage only their part's rows (each with its own row's
// salt), and in a bucket range only the leads that fall in it.  A cell's
// terms, their lead sums and their order are those of one whole-table
// block, so a split table has its bits.  Where a thread block cluster
// holds the table and measured faster (kernels/tiling.py det_cluster),
// the scatter takes det_cluster_block instead.  (The dense update's det
// variant has a block body of its own, det_dense_block below.)
template <class Slots, class Entry, int kSplit>
__device__ __forceinline__ void det_table_block(const Slots& slots,
                                                const TableArgs& a,
                                                float* table) {
  const DetPart d = det_part<kSplit>(a);
  int b;
  int64_t begin, end;
  block_range(a, d.blk, b, begin, end);
  const int cells = (d.r1 - d.r0) * d.wn;
  float* stages = table + d.srows * d.span;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;
  __syncthreads();
  const int tiles =
      end > begin ? static_cast<int>((end - begin + kDetStage - 1) / kDetStage)
                  : 0;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  if (warp < kDetProducers) {
    det_produce<Slots, Entry, kSplit>(slots, a, d, stages, b, begin, end,
                                      tiles);
  } else {
    det_walk<Entry>(a, d, table, stages, warp - kDetProducers,
                    d.srows < kDetMaxWalkers ? d.srows : kDetMaxWalkers,
                    tiles);
  }
  __syncthreads();
  det_flush(a, d, b, table);
}

// ---------------------------------------------------------------------------
// The deterministic block body of the dense update (countsketch_update.cu
// worp_countsketch_update_det; its plan is kernels/tiling.py table_plan
// with det_chunks): one block a chunk of a segment, its table summed in the
// det scatter's order, which for a dense segment reads: in each row, the
// live slots of a 32-slot group (counted from slot 0) that fall in one cell
// sum their signed terms in slot order, d = (t1 + t2) + ..., and the cell
// takes cell + d, group by group in slot order, from 0.0f (kernels/ref.py
// countsketch_update_det_ref, one chunk).
//
// Why not det_table_block.  The order fixes a cell's terms only within its
// row, and a dense segment's keys are distinct, so no key matching is
// needed.  In det_table_block 8 producer warps hash every row of a stage
// and a walker warp a row adds it: the hashing ran on 24 warps an SM and
// the slowest producer paced each stage.  Here a row's bucket and sign
// hashing lives in the warp that adds that row, so every warp hashes and
// no row's entries pass from one warp to another:
//   * warp w owns rows w, w + warps, ... (warps = min(rows,
//     kDenseMaxWarps)).  For a row, each lane hashes kDenseAhead groups
//     ahead (independent hash chains), then adds them in group order with
//     the det walker's test: each live lane reads its cell, marks it with
//     its lane's tag and reads the mark back; where every lane reads its
//     own tag no two slots share a cell and each adds its term with a plain
//     store, else the warp matches the buckets and sums each to its lowest
//     lane in lane order (ordered_combine) first.  A full stage takes a
//     walk with every lane live (det_dense_walk<true>): no predicate, no
//     group check.  The sign goes into the term by an XOR of sign_mask
//     (hashing.cuh), a multiply where the bit tests were.
//   * the transform, some 78 of the 358 operations a slot, runs once a
//     slot, never once a row: every thread transforms kDenseSlotsPerThread
//     slots of the next stage (loaded into registers a stage ahead) into a
//     double-buffered stage of transformed values in shared memory beside
//     the table, after it has walked the current stage.  One __syncthreads
//     a stage hands it over; every warp does the same work between two of
//     them.  Without the transform the stage holds the values.
// Shared memory: the table and two stages of kDenseSlotsPerThread x threads
// floats: 57,344 + 7,168 B for rows 7 x width 2048 (224 threads), 3 blocks
// (21 warps) an SM.
//
// What the card showed (chip_smoke.py --det-parent on trial trees, H100
// 80GB HBM3, 700.00 W; PERF.md has the times): the walk costs as much as
// the hashing and the two add up, so every instruction of either counts.
// The full-stage walk and sign_mask gave the most; a __match_any_sync in
// place of the tag test took twice the time (match is slow on the card),
// an atomicExch tag (one access fewer) was slower, and so were hashing 8
// groups ahead and the fill spread over the walk; 8 slots a thread were
// 2 % faster but narrow the widest table (7,789 buckets at rows 7, where
// 4 slots admit 8,045 and the design this replaced 7,970).
constexpr int kDenseMaxWarps = 8;       // row-owning warps a block at most
constexpr int kDenseSlotsPerThread = 4;  // a stage: this x threads slots
constexpr int kDenseAhead = 4;          // groups a lane hashes ahead

// Adds one 32-slot group of a row in the det order: lane l holds slot l's
// bucket and signed term; `live` false past the segment's end.
__device__ __forceinline__ void det_add_group(float* row, uint32_t bucket,
                                              float v, bool live,
                                              uint32_t tag) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  float* cell = row + bucket;
  const float old = live ? *cell : 0.0f;
  __syncwarp();
  if (live) *cell = __uint_as_float(tag);
  __syncwarp();
  const bool shared = live && __float_as_uint(*cell) != tag;
  if (__any_sync(kAll, shared)) {  // two slots, one cell
    float d = v;
    const unsigned peers =
        __match_any_sync(kAll, live ? bucket : 0x80000000u | lane);
    if (ordered_combine(peers, live, d)) *cell = __fadd_rn(old, d);
  } else if (live) {
    *cell = __fadd_rn(old, v);
  }
  __syncwarp();  // this group's adds before the next group's reads
}

// Thread t's share of a stage of `stage` slots from slot s0: slots s0 + t,
// s0 + t + threads, ... (coalesced), loaded (0 past the end) ...
__device__ __forceinline__ void det_dense_load(
    const float* __restrict__ values, int64_t row0, int64_t s0, int64_t end,
    float (&raw)[kDenseSlotsPerThread]) {
#pragma unroll
  for (int k = 0; k < kDenseSlotsPerThread; ++k) {
    const int64_t i = s0 + k * static_cast<int>(blockDim.x) + threadIdx.x;
    raw[k] = i < end ? values[row0 + i] : 0.0f;
  }
}

// ... then transformed (where has_p) into the stage buffer.
__device__ __forceinline__ void det_dense_fill(
    const TableArgs& a, uint32_t base, uint32_t tseed, int64_t s0,
    int64_t end, const float (&raw)[kDenseSlotsPerThread], float* buf) {
#pragma unroll
  for (int k = 0; k < kDenseSlotsPerThread; ++k) {
    const int j = k * static_cast<int>(blockDim.x) + threadIdx.x;
    float v = raw[k];
    if (a.has_p && s0 + j < end) {
      const uint32_t key = base + static_cast<uint32_t>(s0 + j);
      v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
    }
    buf[j] = v;
  }
}

// Warp-owned rows over one stage: `count` live slots from slot s0, their
// (transformed) values in buf.  kFull: the stage is full (count is the
// stage), so every lane is live and no group check is needed; only a
// chunk's last stage takes the ragged walk.  The warps own the block's rows
// (DetPart); kSplit kDetRanges: its bucket range of one row, a slot whose
// bucket falls outside it dead for this block.
template <bool kFull, int kSplit>
__device__ __forceinline__ void det_dense_walk(const TableArgs& a,
                                               const DetPart& d,
                                               float* table, const float* buf,
                                               uint32_t base, uint32_t seed,
                                               int64_t s0, int count) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int warps = static_cast<int>(blockDim.x >> 5);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const uint32_t tag = kTag | static_cast<uint32_t>(lane);
  const uint32_t key0 = base + static_cast<uint32_t>(s0) + lane;
  for (int r = d.r0 + warp; r < d.r1; r += warps) {
    const uint32_t salt = row_salt(seed, static_cast<uint32_t>(r));
    float* row = table + static_cast<int64_t>(r - d.r0) * d.wn;
    for (int g0 = 0; g0 * 32 < count; g0 += kDenseAhead) {
      uint32_t bucket[kDenseAhead];
      float term[kDenseAhead];
#pragma unroll
      for (int q = 0; q < kDenseAhead; ++q) {  // independent hash chains
        const int j = (g0 + q) * 32 + lane;
        const uint32_t key = key0 + static_cast<uint32_t>((g0 + q) * 32);
        bucket[q] = bucket_hash(key, salt, width);
        if constexpr (kSplit == kDetRanges) {
          bucket[q] -= static_cast<uint32_t>(d.w0);
        }
        const float v = buf[j];
        term[q] = __uint_as_float(__float_as_uint(v) ^ sign_mask(key, salt));
      }
#pragma unroll
      for (int q = 0; q < kDenseAhead; ++q) {
        const int g = g0 + q;
        if (!kFull && g * 32 >= count) break;  // warp-uniform
        bool live = kFull || g * 32 + lane < count;
        if constexpr (kSplit == kDetRanges) {
          live = live && bucket[q] < static_cast<uint32_t>(d.wn);
        }
        det_add_group(row, bucket[q], term[q], live, tag);
      }
    }
  }
}

// The block takes its range as table_block does (a chunk of stream b, or
// the whole stream where block_ends is null) and writes its table whole:
// to delta row b where each stream is one block, else to row `chunk` of
// the (chunks, rows, width) workspace that countsketch_chunk_sum sums in
// chunk order.  A table too large for one block goes to a cluster
// (det_cluster_block); past what a cluster holds it is split as the
// scatter's (det_part): each chunk gets a block a row group, or a bucket
// range of one row, whose warps own its rows; every part of a chunk loads
// and transforms all of its slots, and writes its part of the chunk's
// row.  A cell's terms and their order are those of one whole-table
// block, so a split table has its bits.  The stage is kDenseSlotsPerThread x
// blockDim.x slots, a multiple of kDenseAhead groups (blockDim.x a
// multiple of 32), so a stage's hashed-ahead reads stay in its buffer;
// chunks start at multiples of 32, so the groups still count from slot 0.
template <int kSplit>
__device__ __forceinline__ void det_dense_block(
    const float* __restrict__ values, const int32_t* __restrict__ base_keys,
    const TableArgs& a, float* table) {
  const DetPart d = det_part<kSplit>(a);
  int b;
  int64_t begin, end;
  block_range(a, d.blk, b, begin, end);
  const int cells = (d.r1 - d.r0) * d.wn;
  const int stage = kDenseSlotsPerThread * static_cast<int>(blockDim.x);
  float* stages = table + d.srows * d.span;
  const uint32_t base = static_cast<uint32_t>(base_keys[b]);
  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const int64_t row0 = stream_start(a, b);
  const int tiles =
      end > begin ? static_cast<int>((end - begin + stage - 1) / stage) : 0;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;
  float raw[kDenseSlotsPerThread];
  if (tiles > 0) {
    det_dense_load(values, row0, begin, end, raw);
    det_dense_fill(a, base, tseed, begin, end, raw, stages);
  }
  if (tiles > 1) det_dense_load(values, row0, begin + stage, end, raw);
  __syncthreads();  // the table zeroed, stage 0 filled
  for (int t = 0; t < tiles; ++t) {
    const int64_t s0 = begin + static_cast<int64_t>(t) * stage;
    const int64_t left = end - s0;
    if (left >= stage) {
      det_dense_walk<true, kSplit>(a, d, table, stages + (t & 1) * stage,
                                   base, seed, s0, stage);
    } else {
      det_dense_walk<false, kSplit>(a, d, table, stages + (t & 1) * stage,
                                    base, seed, s0, static_cast<int>(left));
    }
    if (t + 1 < tiles) {  // stage t - 1's buffer: every warp is past it
      det_dense_fill(a, base, tseed, s0 + stage, end, raw,
                     stages + ((t + 1) & 1) * stage);
      if (t + 2 < tiles) {
        det_dense_load(values, row0, s0 + 2 * stage, end, raw);
      }
    }
    __syncthreads();  // stage t walked everywhere, stage t + 1 filled
  }
  det_flush(a, d, a.block_ends == nullptr ? b : d.blk, table);
}

// ---------------------------------------------------------------------------
// The det body of a table too large for one block, over a thread block
// cluster (kernels/tiling.py det_cluster; the scatter's
// countsketch_scatter_det_cluster and the dense update's
// countsketch_update_det_cluster): one cluster a stream (scatter) or a
// chunk (dense update), its C <= 8 CTAs each owning a slice of the
// table, a row group (kDetRows) or a bucket range of one row
// (kDetRanges), sized so that two or more CTAs fit an SM.  The order is
// det_table_block's (and, for dense slots, det_dense_block's): a cell
// takes its group sums in slot order, each group's leads in one bucket
// summed in slot order first.  Only which CTA holds a cell changes, so a
// cluster gives one whole-table block's bits.
//
// A cluster stage is C x kDetStage slots: CTA q's 8 producer warps take
// its q-th kDetStage slots (one 32-slot group a warp), load, transform
// and key-match each slot once, and hash every row.  Per row a producer
// finds the leads that share a bucket (a bitmap a warp, clash_lanes) and,
// where any do, sums their terms in slot order to the lowest of them
// (ordered_combine); then it pushes each adding lane's term and bucket,
// and the group's mask of adding lanes, into the owning CTA's inbox with
// st.shared::cluster (a bucket range's owner gets only the leads that
// fall in it).  Each CTA's walker warps (one a row of its slice, at most
// 8) read only their own inbox, CTA by CTA in rank order, which is slot
// order, and add a group in one step: no two of its lanes name one cell,
// so each takes cell + d with a load, an add and a store.
//
// What design trials on the card showed (H100 80GB HBM3, 700.00 W; not
// kept as measurements): walkers that pulled the stages from the
// producers' CTAs (ld.shared::cluster) waited on the network at every
// stage, where stores do not wait; a __match_any_sync a row, or ballots
// over 14 bucket bits, for the clash test cost the producers far more
// than the bitmap; the tag test in the walker (det_add_group) on the few
// groups that clash slowed the walk more than the producers' sums cost
// them; and a producer warp is latency-bound, so four warps of two
// groups each (which would let a walker add a pair of groups in one
// step) were slower than eight warps of one.
//
// One cluster barrier a stage (arrive.release, wait.acquire, every
// thread of the cluster) hands the two inbox buffers over: stage t + 1 is
// pushed while stage t is walked.  The first barrier comes before any
// store to another CTA (all resident, the tables zeroed); the last after
// the last walk, so each CTA then writes its slice and exits with
// nothing in flight to it.
//
// Budget: at the gemma2_2b layer's 7 x 16,384 table a CTA is one row,
// 65,536 B, two inbox stages of 7 x 1,568 B and 8 bitmaps of 16,384 bits:
// 103,872 B, so 2 CTAs of 9 warps an SM at 48 registers, 32 clusters of
// 7 active at once; one row of 100,000 is 8 CTAs of 12,500 buckets,
// 76,112 B, 3 an SM, 45 clusters active.  Times there: 7.08-7.09 ms (the
// block split it replaced 11.97-11.98 ms) and 1.084-1.085 ms (4.79-4.81
// ms), raw, in turns (chip_smoke.py --det-parent, H100 80GB HBM3, 700.00
// W).  The walk, a warp a row stepping group after group, and the
// producers take about as long as each other; with two CTAs an SM only
// two rows are walked at once, which bounds the layer.

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address, in CTA `rank` of this cluster, of what lies
// at `p` in this CTA's shared memory.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(addr), "h"(v)
               : "memory");
}

// Bytes of one stage of a cluster CTA's inbox: for each of its `srows`
// rows and each of the cluster's `parts` CTAs' kDetStage slots, a live
// mask a group, a term and a bucket a slot (kernels/tiling.py
// det_cluster_smem_bytes).
__host__ __device__ constexpr int det_inbox_bytes(int parts, int srows,
                                                  int bucket_bytes) {
  return parts * srows *
         (kDetGroups * 4 + kDetStage * 4 + kDetStage * bucket_bytes);
}

// One stage of a cluster CTA's inbox; the same offsets in every CTA.  Row
// rr's stage of CTA q is item rr x parts + q.
template <class Bucket>
struct Inbox {
  uint32_t* live;  // items x kDetGroups: the lanes that add, a bit a lane
  float* term;     // items x kDetStage: the sum a lane adds to its cell
  Bucket* bucket;  // items x kDetStage: its cell, from the slice's first

  __device__ __forceinline__ Inbox(float* stages, int parts, int srows,
                                   int s) {
    char* base = reinterpret_cast<char*>(stages) +
                 s * det_inbox_bytes(parts, srows,
                                     static_cast<int>(sizeof(Bucket)));
    const int items = parts * srows;
    live = reinterpret_cast<uint32_t*>(base);
    term = reinterpret_cast<float*>(live + items * kDetGroups);
    bucket = reinterpret_cast<Bucket*>(term + items * kDetStage);
  }
};

// The leads that share, or may share, a bucket with a lead before them:
// each lead sets its bucket's bit in its warp's bitmap of `bits` (a power
// of two) with atomicOr, and one that finds it set already is marked;
// then the bits are cleared.  Two leads of one bucket mark the later;
// leads whose buckets differ but agree below `bits` may mark one too,
// which costs a __match_any_sync and changes no bit.
__device__ __forceinline__ unsigned clash_lanes(uint32_t bucket, bool lead,
                                                uint32_t* bitmap,
                                                uint32_t bits) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const uint32_t h = bucket & (bits - 1u);
  bool hit = false;
  if (lead) {
    const uint32_t bit = 1u << (h & 31u);
    hit = (atomicOr(bitmap + (h >> 5), bit) & bit) != 0u;
  }
  const unsigned clash = __ballot_sync(kAll, hit);  // every lane's atomicOr
  if (lead) bitmap[h >> 5] = 0u;
  __syncwarp();  // cleared before the next row's atomicOr
  return clash;
}

// The producers of CTA `rank`: its share of each cluster stage (slots
// begin + t x step + rank x kDetStage + [0, kDetStage)), a 32-slot group
// a warp.  For each row a lead's term is sign * its key's sum; where
// leads of the group share the row's bucket (clash_lanes, then
// __match_any_sync), they sum their terms in slot order to the lowest of
// them (ordered_combine), so each cell is named by one lane of the group,
// which then adds cell + d as the order has it.  The adding lanes' terms
// and buckets (counted from the owner's first) and their mask go to the
// owning CTA's inbox.  `tiles` + 1 cluster barriers, the walkers' count.
template <class Slots, class Bucket, int kSplit>
__device__ __forceinline__ void det_cluster_produce(
    const Slots& slots, const TableArgs& a, const DetPart& d, float* stages,
    uint32_t* bitmap, uint32_t bits, int rank, int parts, int b,
    int64_t begin, int64_t end, int tiles) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int g = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const uint32_t seed = static_cast<uint32_t>(a.seeds[b]);
  const uint32_t tseed = static_cast<uint32_t>(a.tseeds[b]);
  const uint32_t width = static_cast<uint32_t>(a.width);
  const uint32_t span = static_cast<uint32_t>(d.span);
  const int64_t row0 = stream_start(a, b);
  const int64_t step = static_cast<int64_t>(parts) * kDetStage;
  const int slot = rank * kDetStage + g * 32 + lane;  // in a cluster stage
  const int group = rank * kDetGroups + g;
  int64_t i = begin + slot;
  // this lane's next slot, loaded a stage ahead (key -1 loads as kDeadKey)
  uint32_t key1 = kDeadKey;
  float v1 = 0.0f;
  if (i < end) slots(b, i, row0 + i, key1, v1);
  for (int t = 0; t <= tiles; ++t, i += step) {
    if (t < tiles) {
      const uint32_t key = key1;
      float v = v1;
      key1 = kDeadKey;
      if (i + step < end) slots(b, i + step, row0 + i + step, key1, v1);
      const bool live = Slots::kCombine ? key != kDeadKey : i < end;
      if (live && a.has_p) {
        v = transform_value(v, key, tseed, a.scheme, a.neg_inv_p);
      }
      const bool lead = Slots::kCombine
                            ? ordered_combine(__match_any_sync(kAll, key),
                                              live, v)
                            : live;
      const Inbox<Bucket> box(stages, parts, d.srows, t & 1);
      int c = 0, rr = 0;  // kDetRows: row r is row rr of CTA c
      for (int r = 0; r < a.rows; ++r) {
        const uint32_t salt = row_salt(seed, static_cast<uint32_t>(r));
        uint32_t bucket = bucket_hash(key, salt, width);
        float term = sign_bit(key, salt) ? -v : v;
        bool adds = lead;
        if (clash_lanes(bucket, lead, bitmap, bits) != 0u) {  // rare
          const unsigned peers =
              __match_any_sync(kAll, lead ? bucket : 0x80000000u | lane);
          adds = ordered_combine(peers, lead, term);
        }
        int item = rr * parts + rank;  // row rr of CTA c, from this CTA
        if constexpr (kSplit == kDetRanges) {  // the range of the bucket
          const uint32_t k = bucket / span;
          bucket -= k * span;
          c = r * a.ranges + static_cast<int>(k);
          item = rank;
          for (int q = 0; q < a.ranges; ++q) {
            const unsigned mine = __ballot_sync(kAll, adds && k == q);
            if (lane == 0) {
              st_cluster(cluster_addr(box.live + group, r * a.ranges + q),
                         mine);
            }
          }
        } else {
          const unsigned mask = __ballot_sync(kAll, adds);
          if (lane == 0) {
            st_cluster(cluster_addr(box.live + (item * kDetGroups + g), c),
                       mask);
          }
        }
        if (adds) {
          const int at = item * kDetStage + g * 32 + lane;
          st_cluster(cluster_addr(box.term + at, c), term);
          st_cluster(cluster_addr(box.bucket + at, c),
                     static_cast<Bucket>(bucket));
        }
        if constexpr (kSplit == kDetRows) {
          if (++rr == a.row_group) {
            rr = 0;
            ++c;
          }
        }
      }
    }
    cluster_barrier();  // stage t pushed, stage t - 1 walked everywhere
  }
}

// Walker `walker` of `walkers` of a CTA that owns DetPart d: after each
// cluster barrier, stage t - 1 of its inbox, CTA by CTA (slot order), each
// of its rows' adding lanes taking cell + d, one group after another: no
// two lanes of a group name one cell.  A stage's 8 groups of a row are
// loaded ahead into registers.
template <class Bucket>
__device__ __forceinline__ void det_cluster_walk(const DetPart& d,
                                                 float* table, float* stages,
                                                 int parts, int walker,
                                                 int walkers, int tiles) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int nrows = d.r1 - d.r0;
  for (int t = 0; t <= tiles; ++t) {
    if (t > 0) {
      const Inbox<Bucket> box(stages, parts, d.srows, (t - 1) & 1);
      for (int rr = walker; rr < nrows; rr += walkers) {
        float* row = table + static_cast<int64_t>(rr) * d.wn;
        for (int q = 0; q < parts; ++q) {
          const int item = rr * parts + q;  // row rr's stage of CTA q
          unsigned live[kDetGroups];
          uint32_t bucket[kDetGroups];
          float term[kDetGroups];
#pragma unroll
          for (int g = 0; g < kDetGroups; ++g) {
            live[g] = box.live[item * kDetGroups + g];
            bucket[g] = box.bucket[item * kDetStage + g * 32 + lane];
            term[g] = box.term[item * kDetStage + g * 32 + lane];
          }
#pragma unroll
          for (int g = 0; g < kDetGroups; ++g) {
            if (live[g] == 0u) continue;  // warp-uniform
            if ((live[g] >> lane) & 1u) {
              row[bucket[g]] = __fadd_rn(row[bucket[g]], term[g]);
            }
            __syncwarp();  // this group's adds before the next's reads
          }
        }
      }
    }
    cluster_barrier();
  }
}

// A CTA of a det cluster: block g is CTA g % parts (its rank) of the
// cluster of stream or chunk g / parts, as det_part gives it, and writes
// its slice to delta row b (one cluster a stream) or to workspace row
// g / parts (a chunk's table, summed in chunk order by the second pass).
// Its inbox holds buckets counted from its slice's first (Bucket: 16 bits
// where its rows span at most 2**16 buckets).
template <class Slots, class Bucket, int kSplit>
__device__ __forceinline__ void det_cluster_block(const Slots& slots,
                                                  const TableArgs& a,
                                                  int clash_bits,
                                                  float* table) {
  const DetPart d = det_part<kSplit>(a);
  const int parts = kSplit == kDetRanges
                        ? a.rows * a.ranges
                        : (a.rows + a.row_group - 1) / a.row_group;
  const int rank = static_cast<int>(blockIdx.x) - d.blk * parts;
  int b;
  int64_t begin, end;
  block_range(a, d.blk, b, begin, end);
  const int cells = (d.r1 - d.r0) * d.wn;
  float* stages = table + d.srows * d.span;
  // after the two inbox stages, a producer warp's clash bitmap each
  uint32_t* bitmaps = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(stages) +
      2 * det_inbox_bytes(parts, d.srows,
                          static_cast<int>(sizeof(Bucket))));
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0.0f;
  for (int c = threadIdx.x; c < kDetProducers * clash_bits / 32;
       c += blockDim.x) {
    bitmaps[c] = 0u;
  }
  const int64_t step = static_cast<int64_t>(parts) * kDetStage;
  const int tiles =
      end > begin ? static_cast<int>((end - begin + step - 1) / step) : 0;
  cluster_barrier();  // the cluster resident, every table zeroed
  const int warp = static_cast<int>(threadIdx.x >> 5);
  if (warp < kDetProducers) {
    det_cluster_produce<Slots, Bucket, kSplit>(
        slots, a, d, stages, bitmaps + warp * (clash_bits / 32),
        static_cast<uint32_t>(clash_bits), rank, parts, b, begin, end,
        tiles);
  } else {
    det_cluster_walk<Bucket>(
        d, table, stages, parts, warp - kDetProducers,
        d.srows < kDetMaxWalkers ? d.srows : kDetMaxWalkers, tiles);
  }
  det_flush(a, d, a.block_ends == nullptr ? b : d.blk, table);
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

// Launches `kernel` on `blocks` blocks of `threads` in clusters of
// `cluster` CTAs (blocks a multiple of it), with `smem_bytes` of dynamic
// shared memory (opted in first) on `stream`.  Returns a CUDA error code.
template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), int blocks, int threads,
                   int smem_bytes, int cluster, cudaStream_t stream,
                   Args... args) {
  int err = prepare_table_kernel(kernel, smem_bytes);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// kernel_info of a cluster kernel (out[0..3]) and, in out[4], the
// clusters of `cluster` CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters).
template <class Kernel>
int cluster_info(Kernel* kernel, int threads, int smem_bytes, int cluster,
                 int* out) {
  int err = prepare_table_kernel(kernel, smem_bytes);
  if (!err) err = kernel_info(kernel, threads, smem_bytes, out);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out + 4, kernel, &cfg));
}

}  // namespace worp

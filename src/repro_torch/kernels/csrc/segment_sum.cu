// Sorted segment sum for Hopper (sm_90a), the deterministic mode's form of
// the segment sums of the flush (repro_torch/core/worp.py segment_sum).
//
// Stands in, under torch.use_deterministic_algorithms(True), for PyTorch's
// scatter_add_ there; the reference computes the same sums with
// jax.ops.segment_sum (src/repro/core/worp.py:70 in _dedup_topc, and
// src/repro/core/counters.py), in XLA, not in a pallas_call.  On the card
// PyTorch's deterministic scatter_add_ sorts its indices first: 7.97 ms at
// the flush's (4096, 5632) and 61.34 ms at the TV cascade's (32768, 5632)
// (chip_smoke.py, H100 80GB HBM3, 700.00 W).
//
// Computes, for rows of n slots whose segment ids seg[r, i] count the runs
// of a stably sorted key row (nondecreasing from 0),
//   out[r, s] = sum of values[r, i] over the i with seg[r, i] == s
// and leaves out[r, s] as the caller zeroed it for s past the row's last
// run (and for ids outside [0, n), which it skips).  Each run is summed by
// one thread in index order from 0.0f, so every launch gives the same bits,
// and they are the bits of PyTorch's CPU scatter_add_, which adds in the
// same order.  A tree or shuffle reduction would change them.
//
// Design (kernels/tiling.py segment_plan): a block of 256 threads takes one
// row, or as many whole short rows as fill a 1024-slot tile, and walks its
// rows' slots as one range, tile by tile, in order:
//   * the next tile's values and ids are copied into shared memory with
//     cp.async while this tile is summed (two buffers; 16-byte copies where
//     n is a multiple of 4 and both arrays start on 16 bytes, else 4 and 8);
//   * one block-wide pass marks run heads (a row's first slot, or an id
//     other than the slot before's) into a ballot mask a warp, a block scan
//     of each thread's 4 slots numbers the runs, and each head records its
//     position, so every run's start and end are known before its sum;
//   * thread t sums runs t, t + 256, ... from shared memory, a loop of
//     known length whose chain is the FADD latency, not a global load, and
//     writes each sum once (coalesced: neighbouring runs, neighbouring
//     ids).  The tile's last run is carried: the next tile's thread 0 goes
//     on adding its continuation, in order, from the carried partial sum,
//     and writes it where the run ends (or after the range's last tile).
//
// Bound: each slot's value (4 B) and segment id (8 B) read once and its
// output (4 B) written once, 16 B a slot: device-memory bytes, 0.110 ms at
// the flush shape.  Budget: 24,576 B of staged tiles and 2.2 KB of run
// positions, masks and carry a block (26,808 B), so 8 blocks (2048
// threads) an SM at 32 registers a thread (__launch_bounds__(256, 8)).
// Measured, over two runs: 0.166-0.173 ms at the flush's (4096, 5632),
// 64-67 % of the bound, and 1.166-1.176 ms at the TV cascade's (32768,
// 5632), 75-76 %, where the atomic scatter_add_ took 0.399-0.404 and
// 3.05-3.06 ms in the same runs and the design this replaced (one thread a
// slot, a head walking its run in global memory) 0.585 and 4.04 ms
// (chip_smoke.py, H100 80GB HBM3, 700.00 W), the wrapper's zero fill
// included.  A long row is one block's serial walk
// (a row of 10^5 slots: 98 tiles).
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kPer = kTile / kThreads;  // slots a thread marks and scans
constexpr int kWords = kTile / 32;      // head-mask words a tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies `count` slots of values and ids (from flat slot `first`) into a
// tile buffer; kVec: 16-byte copies (count a multiple of 4, `first` too).
template <bool kVec>
__device__ __forceinline__ void load_tile(float* sv, int64_t* ss,
                                          const float* values,
                                          const int64_t* seg, int64_t first,
                                          int count) {
  const float* v = values + first;
  const int64_t* g = seg + first;
  if constexpr (kVec) {
    for (int c = threadIdx.x; c < count / 4; c += kThreads) {
      cp_async(sv + 4 * c, v + 4 * c, 16);
    }
    for (int c = threadIdx.x; c < count / 2; c += kThreads) {
      cp_async(ss + 2 * c, g + 2 * c, 16);
    }
  } else {
    for (int c = threadIdx.x; c < count; c += kThreads) {
      cp_async(sv + c, v + c, 4);
      cp_async(ss + c, g + c, 8);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
    segment_sum_kernel(const float* __restrict__ values,
                       const int64_t* __restrict__ seg,
                       float* __restrict__ out, int64_t rows, int64_t n,
                       int64_t rows_per_block) {
  __shared__ __align__(16) float sv[2][kTile];
  __shared__ __align__(16) int64_t ss[2][kTile];
  __shared__ uint16_t head_pos[kTile + 1];
  __shared__ uint32_t heads[kWords];
  __shared__ int warp_heads[kWarps];
  __shared__ float carry_sum;    // the partial sum of the tile's last run
  __shared__ int64_t carry_out;  // its flat output index; -1: none
  __shared__ int64_t last_seg;   // the previous tile's last id

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int64_t begin = r0 * n;  // the block's flat range [begin, end)
  const int64_t len = (r1 - r0) * n;
  const int64_t tiles = (len + kTile - 1) / kTile;
  if (tid == 0) carry_out = -1;

  load_tile<kVec>(sv[0], ss[0], values, seg, begin,
                  static_cast<int>(len < kTile ? len : kTile));
  cp_async_commit();
  for (int64_t t = 0; t < tiles; ++t) {
    const int buf = static_cast<int>(t & 1);
    const int64_t off = t * kTile;  // in the block's range
    const int tl = static_cast<int>(len - off < kTile ? len - off : kTile);
    if (t + 1 < tiles) {
      const int64_t noff = off + kTile;
      load_tile<kVec>(sv[buf ^ 1], ss[buf ^ 1], values, seg, begin + noff,
                      static_cast<int>(len - noff < kTile ? len - noff
                                                          : kTile));
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (the next one's may fly)
    __syncthreads();
    const float* v = sv[buf];
    const int64_t* s = ss[buf];

    // 1. run heads, slot j = tid + k * kThreads: a ballot mask a warp
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      bool head = false;
      if (j < tl) {
        const int64_t o = off + j;
        // o, n < kTile where rows share a block
        const bool row_start =
            rows_per_block == 1
                ? o == 0
                : static_cast<int>(o) % static_cast<int>(n) == 0;
        head = row_start || s[j] != (j > 0 ? s[j - 1] : last_seg);
      }
      const unsigned m = __ballot_sync(0xFFFFFFFFu, head);
      if (lane == 0) heads[k * kWarps + warp] = m;
    }
    __syncthreads();

    // 2. number the runs: a block scan of each thread's kPer slots
    const unsigned mine =
        (heads[tid * kPer / 32] >> (tid * kPer % 32)) & ((1u << kPer) - 1u);
    int x = __popc(mine);
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_heads[warp] = x;
    const float old_sum = carry_sum;  // read before step 3 rewrites them
    const int64_t old_out = carry_out;
    __syncthreads();
    int first = x - __popc(mine);
    int nh = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_heads[w];
      if (w < warp) first += h;
      nh += h;
    }
    for (unsigned m = mine; m; m &= m - 1u) {
      head_pos[first++] = static_cast<uint16_t>(tid * kPer + __ffs(m) - 1);
    }
    if (tid == 0) head_pos[nh] = static_cast<uint16_t>(tl);
    __syncthreads();

    // 3. the sums, each run in index order from 0.0f (the carried run from
    //    its partial sum); the tile's last run is carried, not written
    if (tid == 0) {
      const int e0 = nh > 0 ? head_pos[0] : tl;
      if (e0 > 0) {  // the carried run goes on into this tile
        float sum = old_sum;
        for (int j = 0; j < e0; ++j) sum = __fadd_rn(sum, v[j]);
        if (nh == 0) {
          carry_sum = sum;
        } else if (old_out >= 0) {
          out[old_out] = sum;
        }
      } else if (old_out >= 0) {  // it ended with the last tile
        out[old_out] = old_sum;
      }
      last_seg = s[tl - 1];
    }
    for (int k = tid; k < nh; k += kThreads) {
      const int a = head_pos[k];
      const int e = head_pos[k + 1];
      float sum = 0.0f;
      for (int j = a; j < e; ++j) sum = __fadd_rn(sum, v[j]);
      const int64_t id = s[a];
      const int64_t o = off + a;
      const int64_t row =
          rows_per_block == 1
              ? begin
              : begin + static_cast<int64_t>(static_cast<int>(o) /
                                             static_cast<int>(n)) * n;
      const int64_t at = id >= 0 && id < n ? row + id : -1;
      if (k == nh - 1) {
        carry_sum = sum;
        carry_out = at;
      } else if (at >= 0) {
        out[at] = sum;
      }
    }
    __syncthreads();  // this buffer is refilled next
  }
  if (tid == 0 && carry_out >= 0) out[carry_out] = carry_sum;
}

}  // namespace

// `blocks` blocks of 256 threads, each over `rows_per_block` rows
// (kernels/tiling.py segment_plan); `threads` and `tile`, the plan's
// geometry (tiling.SEGMENT_THREADS, SEGMENT_TILE), must be this kernel's,
// else cudaErrorInvalidValue and no launch; `vec` takes the 16-byte copies
// (n a multiple of 4, values and seg on 16 bytes).  `out` is zeroed by
// the caller.  Launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int worp_segment_sum(const void* values, const void* seg,
                                void* out, int64_t rows, int64_t n,
                                int64_t rows_per_block, int blocks,
                                int threads, int tile, int vec,
                                void* stream) {
  if (threads != kThreads || tile != kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      vec ? segment_sum_kernel<true> : segment_sum_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int64_t*>(seg),
      static_cast<float*>(out), rows, n, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (16-byte copies) or 1 (4 and 8).
extern "C" int worp_segment_sum_info(int variant, int threads,
                                     int smem_bytes, int* out) {
  return worp::kernel_info(variant == 0 ? segment_sum_kernel<true>
                                        : segment_sum_kernel<false>,
                           threads, smem_bytes, out);
}

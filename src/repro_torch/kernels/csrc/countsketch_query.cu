// Batched CountSketch query and estimate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/countsketch_query.py::countsketch_query_batched
// (a one-hot MXU contraction over width blocks, the TPU's form of a gather),
// and, with the median of rows folded in, the estimate built on it
// (countsketch_estimate_batched: that kernel plus jnp.median over rows).
//
// Two kernels, each stream against its own table and seed:
//   the row read (countsketch_query_lanes / _keys), out[b, r, j] =
//       tables[b, r, hash(key, row_salt(seed_b, r)) % W] * sign_r(key);
//   countsketch_estimate_kernel  one thread per (b, j) key, the estimate,
//       out[b, j] = the median over r of those reads, with jnp.median
//       semantics: the mean of the elements at ascending ranks (rows-1)/2
//       and rows/2, rounded as (lo + hi) * 0.5f even where they are one
//       element, and NaN wherever a read is NaN.  That equals
//       countsketch.median under == with NaN equal to NaN; a tie of -0 and
//       +0 may pick either, as torch.sort may, so a zero's sign can differ.
//
// Design: a real gather.  The row read has two layouts, chosen by shape
// (kernels/tiling.py row_read_launch).  Where the B x rows x k reads fit
// one wave of the card's threads (the engine's small reads: query_rows,
// B = 2 x 512 keys), a lane a read: a block a stream's tile of 32 keys, a
// warp a row, so every read is in flight at once, each one hash chain and
// one load, where the design this replaced ran one thread a key through
// its rows' hash chains and loads in turn (4 blocks at B = 2, k = 512,
// rows 7; now 32 blocks of 7 warps, 2x faster).  Past one wave (the
// flush's 4096 x 512 keys) the card is full either way, and a lane a key
// is the faster: it loads its key once and keeps kAhead rows' loads in
// flight, where a lane a read loads each key once a row and was 7-17 %
// slower in trials (chip_smoke.py --det-parent, PERF.md).  Writes are
// 128-byte runs of out[b, r, :] in both.  The estimate's thread hashes its
// key once per row and issues every row's load before it uses one, so a
// key's reads are in flight together; it keeps them in registers (at most
// kMaxFusedRows, with rows as a run-time bound on fully unrolled loops)
// and ranks them with one comparison per pair, the later index ranking
// above on a tie, so the ranks are a permutation and the two middle ranks
// pick lo and hi.  Consecutive threads write consecutive j, so the (B, k)
// estimates are coalesced.  The product with +-1 is exact, so the row read
// equals its plain version bit for bit.
//
// Bound: per key, rows x (two hash_u32 + a mask, hashing.cuh's bucket of a
// power-of-two width; a modulo otherwise), some 336 integer operations at
// 7 rows, against 4 B of key read, 7 random 4 B table reads (whole 32 B
// sectors move) and 28 B written by the row read, 4 B by the estimate:
// the row read is bound by the sectors it reads and the reads it writes.
// The rank count adds 79 operations at 7 rows, where a median network needs
// 29; the estimate saves the (B, rows, k) write and the sort over rows
// that read it back.
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"

namespace {

// Rows the estimate kernel holds in registers (kernels/countsketch_query.py
// MAX_FUSED_ROWS); more rows take the row read and the plain median.
constexpr int kMaxFusedRows = 16;

// Layout 1 (kernels/tiling.py ROW_READ_LANES, reads within one wave of the
// card's threads): a lane a read.  A block takes stream b's keys j0 ..
// j0 + 31, a warp a row (rows past 32: the warps loop), lane l key j0 + l:
// each read hashes its key once for its row and issues one load, and warp
// r writes out[b, r, j0 ...] in one 128-byte run.  The block's 32 keys are
// loaded once a warp, from L1 after the first.
__global__ void countsketch_query_lanes(const float* __restrict__ tables,
                                        const int32_t* __restrict__ keys,
                                        const int32_t* __restrict__ seeds,
                                        float* __restrict__ out, int B, int k,
                                        int rows, int width) {
  const int tiles = (k + 31) / 32;
  const int b = static_cast<int>(blockIdx.x) / tiles;
  const int j = (static_cast<int>(blockIdx.x) - b * tiles) * 32 +
                static_cast<int>(threadIdx.x & 31);
  if (j >= k) return;
  const uint32_t key =
      static_cast<uint32_t>(keys[static_cast<int64_t>(b) * k + j]);
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  for (int r = static_cast<int>(threadIdx.x >> 5); r < rows;
       r += static_cast<int>(blockDim.x >> 5)) {
    const uint32_t salt = worp::row_salt(seed, static_cast<uint32_t>(r));
    const int64_t br = static_cast<int64_t>(b) * rows + r;
    out[br * k + j] =
        tables[br * width +
               worp::bucket_hash(key, salt, static_cast<uint32_t>(width))] *
        worp::sign_hash(key, salt);
  }
}

// Layout 0 (tiling.ROW_READ_KEYS, reads past one wave): a lane a key, its
// key loaded once and its rows' reads issued kAhead at a time before any
// is written, so each lane keeps kAhead loads in flight; a warp writes
// 128-byte runs of each row.  (8 ahead was no faster at the flush shape:
// chip_smoke.py --det-parent, PERF.md.)
constexpr int kAhead = 4;

__global__ void countsketch_query_keys(const float* __restrict__ tables,
                                       const int32_t* __restrict__ keys,
                                       const int32_t* __restrict__ seeds,
                                       float* __restrict__ out, int B, int k,
                                       int rows, int width) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * k) return;
  const int b = static_cast<int>(idx / k);
  const int j = static_cast<int>(idx - static_cast<int64_t>(b) * k);
  const uint32_t key = static_cast<uint32_t>(keys[idx]);
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  const float* table = tables + static_cast<int64_t>(b) * rows * width;
  float* dst = out + static_cast<int64_t>(b) * rows * k + j;
  for (int r0 = 0; r0 < rows; r0 += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {  // independent loads
      const int r = r0 + q;
      if (r < rows) {
        const uint32_t salt = worp::row_salt(seed, static_cast<uint32_t>(r));
        v[q] = table[static_cast<int64_t>(r) * width +
                     worp::bucket_hash(key, salt,
                                       static_cast<uint32_t>(width))] *
               worp::sign_hash(key, salt);
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (r0 + q < rows) dst[static_cast<int64_t>(r0 + q) * k] = v[q];
    }
  }
}

__global__ void countsketch_estimate_kernel(const float* __restrict__ tables,
                                            const int32_t* __restrict__ keys,
                                            const int32_t* __restrict__ seeds,
                                            float* __restrict__ out, int B,
                                            int k, int rows, int width) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * k) return;
  const int b = static_cast<int>(idx / k);
  const uint32_t key = static_cast<uint32_t>(keys[idx]);
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  const float* table = tables + static_cast<int64_t>(b) * rows * width;

  // every row's load first, its sign as a bit: no load waits on another
  float v[kMaxFusedRows];
  uint32_t negative = 0u;
#pragma unroll
  for (int r = 0; r < kMaxFusedRows; ++r) {
    if (r >= rows) break;
    const uint32_t salt = worp::row_salt(seed, static_cast<uint32_t>(r));
    const uint32_t bucket =
        worp::bucket_hash(key, salt, static_cast<uint32_t>(width));
    v[r] = table[static_cast<int64_t>(r) * width + bucket];
    negative |= (worp::sign_hash(key, salt) < 0.0f ? 1u : 0u) << r;
  }
  bool nan = false;
  int rank[kMaxFusedRows];
#pragma unroll
  for (int r = 0; r < kMaxFusedRows; ++r) {
    if (r >= rows) break;
    v[r] = __fmul_rn(v[r], (negative >> r) & 1u ? -1.0f : 1.0f);
    nan |= v[r] != v[r];
    rank[r] = 0;
  }
  // rank = the elements below, ties broken by index: for each pair i < j,
  // one of the two counts the other
#pragma unroll
  for (int i = 0; i < kMaxFusedRows; ++i) {
    if (i >= rows) break;
#pragma unroll
    for (int j = i + 1; j < kMaxFusedRows; ++j) {
      if (j >= rows) break;
      if (v[j] < v[i]) {
        ++rank[i];
      } else {
        ++rank[j];
      }
    }
  }
  const int lo_rank = (rows - 1) / 2;
  const int hi_rank = rows / 2;
  float lo = 0.0f;
  float hi = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxFusedRows; ++r) {
    if (r >= rows) break;
    lo = rank[r] == lo_rank ? v[r] : lo;
    hi = rank[r] == hi_rank ? v[r] : hi;
  }
  out[idx] = nan ? __int_as_float(0x7fc00000)
                 : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

}  // namespace

// The row read: `blocks` of `threads` in `layout` 1 (a lane a read:
// B x the 32-key tiles, 32 x min(rows, 32) threads) or 0 (a lane a key:
// B x k lanes) (kernels/tiling.py row_read_launch).  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int worp_countsketch_query(const void* tables, const void* keys,
                                      const void* seeds, void* out, int B,
                                      int k, int rows, int width, int blocks,
                                      int threads, int layout, void* stream) {
  if (layout != 0 && layout != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      layout == 1 ? countsketch_query_lanes : countsketch_query_keys;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(seeds), static_cast<float*>(out), B, k,
      rows, width);
  return static_cast<int>(cudaGetLastError());
}

// The estimate of B streams: (B, k) float32 out, 1 <= rows <= 16 (the
// wrapper checks).  Launches on `stream`; returns cudaGetLastError().
extern "C" int worp_countsketch_estimate(const void* tables, const void* keys,
                                         const void* seeds, void* out, int B,
                                         int k, int rows, int width,
                                         int blocks, int threads,
                                         void* stream) {
  if (rows < 1 || rows > kMaxFusedRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  countsketch_estimate_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(seeds), static_cast<float*>(out), B, k,
      rows, width);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (the row read, a lane a key), 1 (the
// estimate) or 2 (the row read, a lane a read) at `threads` threads.
extern "C" int worp_countsketch_query_info(int variant, int threads,
                                           int smem_bytes, int* out) {
  if (variant == 1) {
    return worp::kernel_info(countsketch_estimate_kernel, threads, smem_bytes,
                             out);
  }
  if (variant == 2) {
    return worp::kernel_info(countsketch_query_lanes, threads, smem_bytes,
                             out);
  }
  return worp::kernel_info(countsketch_query_keys, threads, smem_bytes, out);
}

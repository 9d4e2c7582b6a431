// Batched dense-segment CountSketch update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/countsketch_update.py::countsketch_update_batched
//   repro/kernels/countsketch_update.py::countsketch_update  (B = 1)
// (a one-hot MXU matmul per width block, because the TPU has no atomics;
// that structure does not carry over).
//
// Computes, for B dense segments of n float32 values, the sketch delta
//   delta[b, r, hash(key, row_salt(seed_b, r)) % W] += sign_r(key) * v'
// where key = (uint32)base_keys[b] + i (wrapping mod 2^32) and v' = v *
// r_x^{-1/p} with r_x = Exp1 (ppswor) or U(0,1] (priority) when has_p, else
// v' = v.  Slot (b, i) counts only when i < lengths[b] (the wrapper clamps
// lengths to [0, n]); no key is padding, so key 0xFFFFFFFF is sketched.
// Stream b's values are row b of a (B, n) array, or, through the entries
// named *_packed, lengths[b] values from offsets[b] of one packed vector
// (the streams back to back, no padding; n is then the longest length and
// only sizes the launch), so ragged streams take O(sum of lengths) memory.
//
// Two entries, chosen by shape before the launch (kernels/tiling.py
// table_plan), never by a failed launch:
//   * worp_countsketch_update_smem, where the rows x width table fits a
//     block's shared memory (rows 7 with width <= 8192): one block per
//     (stream, chunk), the table in shared memory, the block body and its
//     flush in smem_table.cuh.  The key is computed, not loaded.  At one
//     gemma2_2b layer (11 streams, n_max 21.2 M, 77.9 M live slots) the plan
//     gives 1,057 blocks of 74,240 slots, only those that hold live slots
//     (the padded layout has 3x more slots than live ones), each flushing
//     its table with at most 14,336 global atomicAdds into a zeroed delta
//     (about 15 M, where the global design made 545 M).  One segment of
//     21.2 M slots (#4) gives 371 blocks of 57,344.
//   * worp_countsketch_update, for larger tables: one thread per (b, i)
//     slot, rows global atomicAdds into a zeroed delta.
// Both sum in an order that changes from run to run, so the result matches
// the plain version within float tolerance, not bit for bit.
//   * worp_countsketch_update_det, under
//     torch.use_deterministic_algorithms(True): every cell summed in an
//     order fixed by the slot indices and the plan's chunk, the same bits
//     on every run.  A table whose block does not fit (tiling.
//     det_dense_fits) goes to worp_countsketch_update_det_cluster: a
//     thread block cluster a chunk (tiling.det_cluster), each CTA a row
//     group or a bucket range of a row, the chunk's slots loaded,
//     transformed and hashed once a cluster and pushed to the CTAs that
//     own their cells (smem_table.cuh det_cluster_block); past what a
//     cluster holds, it is split (tiling.det_split): each chunk gets a
//     block a row group, or a bucket range of a row where one row does
//     not fit.  Either has the bits one whole-table block would give.
//
// The det variant.  Its block body is the dense update's own
// (smem_table.cuh det_dense_block): a warp a row hashes its row's buckets
// and signs and adds them in slot order, over a stage of transformed values
// that every thread fills, with no key matching, since the keys of a
// segment are distinct.  One block a stream would run the gemma2_2b
// layer's 21.2 M slot wg leaf on one SM, so each block takes one chunk of
// a stream (tiling.table_plan with det_chunks: a multiple of the block's
// stage) and writes its table whole to its row of a (blocks, rows, width)
// workspace.  A second kernel then sums each stream's chunk tables in
// chunk order, each cell from 0.0f, into the delta.  Where one chunk holds
// the longest stream, each stream is one block that writes its delta row
// itself and the second pass is skipped.  kernels/ref.py
// countsketch_update_det_ref is this order in plain PyTorch, and the card
// checks hold the kernel to it bit for bit.  The workspace is 57,344 B a
// block at the defaults, read once by the second pass.
//
// Budget: 57,344 B of shared memory a block at the defaults and 31
// registers a thread, so 4 blocks of 512 threads an SM (chip_smoke.py
// prints both); the det variant 64,512 B and 224 threads, 3 blocks an SM.
// The bucket of a power-of-two width is hash & (W - 1), bit for bit
// hash % W (hashing.cuh).
//
// Bound: per live slot, 7 rows x (two hash_u32 + a mask) plus the
// transform's hash, log and pow, some 358 32-bit operations, against 4
// bytes read: the integer issue rate bounds it (1.667 ms at the gemma2_2b
// layer, 0.454 ms for one 21.2 M segment, PERF.md), not device-memory
// bytes.  Dense keys are distinct, so no bucket is hot and each lane adds
// on its own.  The global-atomic design ran the layer's 545 M atomics, all
// to L2, in 8.61-9.42 ms, and one 21.2 M segment in 2.30-2.83 ms; the
// shared-memory design runs the layer in 2.18-2.50 ms (67-76 % of its
// bound) and the segment in 0.653-0.721 ms (63-70 %) (chip_smoke.py, H100
// 80GB HBM3, 700.00 W).  The det variant runs the layer in 2.30-2.32 ms
// (72 %) and the segment in 0.711-0.719 ms (63-64 %), 1.22x faster than
// the det_table_block body it replaced, launched in the same processes
// (chip_smoke.py --det-parent, H100 80GB HBM3, 700.00 W).  Past one
// block, the cluster runs the layer at 7 x 16,384 in 7.08-7.09 ms (24 %
// of the bound; the block split it replaced 11.97-11.98 ms, the global
// atomics 6.80 ms with their zeroing) and one segment at 1 x 100,000 in
// 1.084-1.085 ms (4.79-4.81 ms), raw, in turns (chip_smoke.py
// --det-parent, H100 80GB HBM3, 700.00 W).
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"
#include "smem_table.cuh"

namespace {

__global__ void countsketch_update_kernel(
    const float* __restrict__ values, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ tseeds, const int32_t* __restrict__ base_keys,
    const int32_t* __restrict__ lengths, const int64_t* __restrict__ offsets,
    float* __restrict__ delta, int B, int n, int rows, int width, int has_p,
    float neg_inv_p, int scheme) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * n) return;
  const int b = static_cast<int>(idx / n);
  const int i = static_cast<int>(idx - static_cast<int64_t>(b) * n);
  if (i >= lengths[b]) return;

  const uint32_t k =
      static_cast<uint32_t>(base_keys[b]) + static_cast<uint32_t>(i);
  float v = values[offsets != nullptr ? offsets[b] + i : idx];
  if (has_p) {
    v = worp::transform_value(v, k, static_cast<uint32_t>(tseeds[b]), scheme,
                              neg_inv_p);
  }
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  float* table = delta + static_cast<int64_t>(b) * rows * width;
  for (int r = 0; r < rows; ++r) {
    const uint32_t salt = worp::row_salt(seed, static_cast<uint32_t>(r));
    const uint32_t bucket =
        worp::bucket_hash(k, salt, static_cast<uint32_t>(width));
    const float s = worp::sign_hash(k, salt);
    atomicAdd(table + static_cast<int64_t>(r) * width + bucket, s * v);
  }
}

__global__ void __launch_bounds__(worp::kTableThreads, 3)
    countsketch_update_smem(const float* __restrict__ values,
                            const int32_t* __restrict__ base_keys,
                            worp::TableArgs args) {
  extern __shared__ float table[];
  worp::table_block(worp::DenseSlots{values, base_keys}, args, table);
}

// 224 threads for rows 7, so 3 blocks (64,512 B of shared memory each) an
// SM: at most 85 registers a thread keep them resident.  kSplit: a block
// owns the whole table (worp::kDetWhole), a row group (kDetRows) or a
// bucket range of one row (kDetRanges).
template <int kSplit>
__global__ void __launch_bounds__(32 * worp::kDenseMaxWarps, 3)
    countsketch_update_det(const float* __restrict__ values,
                           const int32_t* __restrict__ base_keys,
                           worp::TableArgs args) {
  extern __shared__ float table[];
  worp::det_dense_block<kSplit>(values, base_keys, args, table);
}

// A CTA of a det cluster (tiling.det_cluster): a chunk's table too large
// for one block spread over the cluster's shared memory, the scatter's
// producer/walker body (smem_table.cuh det_cluster_block) on dense slots,
// each slot loaded and transformed once.  Bucket: 16 bits where a CTA's
// rows span at most 2**16 buckets; kSplit: row groups (worp::kDetRows) or
// bucket ranges of one row (kDetRanges).
template <class Bucket, int kSplit>
__global__ void __launch_bounds__(worp::kTableThreads, 2)
    countsketch_update_det_cluster(const float* __restrict__ values,
                                   const int32_t* __restrict__ base_keys,
                                   worp::TableArgs args, int clash_bits) {
  extern __shared__ float table[];
  worp::det_cluster_block<worp::DenseSlots, Bucket, kSplit>(
      worp::DenseSlots{values, base_keys}, args, clash_bits, table);
}

using DetKernel = void (*)(const float*, const int32_t*, worp::TableArgs);
using ClusterKernel = void (*)(const float*, const int32_t*,
                               worp::TableArgs, int);

// The cluster kernel of CTAs owning `split` (row groups or bucket ranges)
// whose rows span `span` buckets.
ClusterKernel det_cluster_kernel(int span, int split) {
  if (span <= (1 << 16)) {
    return split == worp::kDetRanges
               ? countsketch_update_det_cluster<uint16_t, worp::kDetRanges>
               : countsketch_update_det_cluster<uint16_t, worp::kDetRows>;
  }
  return split == worp::kDetRanges
             ? countsketch_update_det_cluster<uint32_t, worp::kDetRanges>
             : countsketch_update_det_cluster<uint32_t, worp::kDetRows>;
}

// The det kernel of a split (worp::kDetWhole, kDetRows or kDetRanges).
DetKernel det_kernel(int split) {
  if (split == worp::kDetRanges) {
    return countsketch_update_det<worp::kDetRanges>;
  }
  if (split == worp::kDetRows) return countsketch_update_det<worp::kDetRows>;
  return countsketch_update_det<worp::kDetWhole>;
}

// The det variant's second pass: delta[b, c] = ((0 + ws[g0, c]) + ws[g0 +
// 1, c]) + ... over stream b's chunk tables g0 .. block_ends[b] - 1, in
// chunk order; one thread a (stream, cell), coalesced over the cells.
constexpr int kChunkSumThreads = 256;

__global__ void countsketch_chunk_sum(const float* __restrict__ ws,
                                      const int32_t* __restrict__ block_ends,
                                      float* __restrict__ delta, int B,
                                      int cells) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * cells) return;
  const int b = static_cast<int>(idx / cells);
  const int c = static_cast<int>(idx - static_cast<int64_t>(b) * cells);
  float acc = 0.0f;
  for (int g = b == 0 ? 0 : block_ends[b - 1]; g < block_ends[b]; ++g) {
    acc = __fadd_rn(acc, ws[static_cast<int64_t>(g) * cells + c]);
  }
  delta[idx] = acc;
}

// Launches the second pass over B streams' rows x width chunk tables.
int chunk_sum(const void* workspace, const int32_t* ends, void* delta,
              int B, int rows, int width, cudaStream_t s) {
  const int cells = rows * width;
  const int64_t total = static_cast<int64_t>(B) * cells;
  const int sum_blocks =
      static_cast<int>((total + kChunkSumThreads - 1) / kChunkSumThreads);
  countsketch_chunk_sum<<<sum_blocks, kChunkSumThreads, 0, s>>>(
      static_cast<const float*>(workspace), ends, static_cast<float*>(delta),
      B, cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The deterministic variant: `blocks` blocks of `threads` (32 x min(rows
// of a block, 8): a warp a row) and `smem_bytes` (tiling.
// det_dense_smem_bytes of a block's rows: the table and two stages) of
// dynamic shared memory, `blocks` / parts chunks of parts blocks each
// (split, tiling.det_split: row groups of `row_group` rows or, where
// ranges > 1, `ranges` bucket ranges of each row; unsplit, 1).  With
// block_ends null each stream is one chunk and writes its delta row; else
// chunk g is the one that block_ends (the (B,) inclusive prefix sum of
// chunk counts) gives it, writes its table to workspace row g, and the
// second pass sums them into the delta.  Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int worp_countsketch_update_det_packed(
    const void* values, const void* offsets, const void* seeds,
    const void* tseeds, const void* base_keys, const void* lengths,
    const void* block_ends, void* workspace, void* delta, int B, int n,
    int rows, int width, int chunk, int has_p, float neg_inv_p, int scheme,
    int row_group, int ranges, int blocks, int threads, int smem_bytes,
    void* stream) {
  const auto kernel = det_kernel(ranges > 1       ? worp::kDetRanges
                                 : row_group > 0 ? worp::kDetRows
                                                 : worp::kDetWhole);
  int err = worp::prepare_table_kernel(kernel, smem_bytes);
  if (err) return err;
  const auto ends = static_cast<const int32_t*>(block_ends);
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      ends,
      static_cast<float*>(ends == nullptr ? delta : workspace), B, n, rows,
      width, chunk, has_p, scheme, neg_inv_p, row_group, ranges,
      static_cast<const int64_t*>(offsets)};
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, smem_bytes, s>>>(
      static_cast<const float*>(values),
      static_cast<const int32_t*>(base_keys), args);
  err = static_cast<int>(cudaGetLastError());
  if (err || ends == nullptr) return err;
  return chunk_sum(workspace, ends, delta, B, rows, width, s);
}

// The det entry on (B, n) rows of values.
extern "C" int worp_countsketch_update_det(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, const void* block_ends,
    void* workspace, void* delta, int B, int n, int rows, int width,
    int chunk, int has_p, float neg_inv_p, int scheme, int row_group,
    int ranges, int blocks, int threads, int smem_bytes, void* stream) {
  return worp_countsketch_update_det_packed(
      values, nullptr, seeds, tseeds, base_keys, lengths, block_ends,
      workspace, delta, B, n, rows, width, chunk, has_p, neg_inv_p, scheme,
      row_group, ranges, blocks, threads, smem_bytes, stream);
}

// The deterministic variant over thread block clusters (tiling.
// det_cluster): `blocks` CTAs of `threads` (32 x (8 producer warps +
// min(rows of a CTA, 8) walkers)) and `smem_bytes` (tiling.
// det_cluster_smem_bytes), in clusters of `cluster` CTAs, one a chunk
// (block_ends null: one a stream, which writes its delta row); each CTA
// owns a row group of `row_group` rows or, where ranges > 1, one of
// `ranges` bucket ranges of a row, its producer warps' clash bitmaps
// `clash_bits` bits each (tiling.det_clash_bits).  Chunk tables go to the
// workspace and the second pass sums them, as
// worp_countsketch_update_det's.  Launches on `stream`; returns a CUDA
// error code (0 on success).
extern "C" int worp_countsketch_update_det_cluster_packed(
    const void* values, const void* offsets, const void* seeds,
    const void* tseeds, const void* base_keys, const void* lengths,
    const void* block_ends, void* workspace, void* delta, int B, int n,
    int rows, int width, int chunk, int has_p, float neg_inv_p, int scheme,
    int row_group, int ranges, int cluster, int clash_bits, int blocks,
    int threads, int smem_bytes, void* stream) {
  const auto ends = static_cast<const int32_t*>(block_ends);
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      ends,
      static_cast<float*>(ends == nullptr ? delta : workspace), B, n, rows,
      width, chunk, has_p, scheme, neg_inv_p, row_group, ranges,
      static_cast<const int64_t*>(offsets)};
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = worp::launch_cluster(
      det_cluster_kernel(ranges > 1 ? (width + ranges - 1) / ranges : width,
                         ranges > 1 ? worp::kDetRanges : worp::kDetRows),
      blocks, threads, smem_bytes, cluster, s,
      static_cast<const float*>(values),
      static_cast<const int32_t*>(base_keys), args, clash_bits);
  if (err || ends == nullptr) return err;
  return chunk_sum(workspace, ends, delta, B, rows, width, s);
}

// The cluster entry on (B, n) rows of values.
extern "C" int worp_countsketch_update_det_cluster(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, const void* block_ends,
    void* workspace, void* delta, int B, int n, int rows, int width,
    int chunk, int has_p, float neg_inv_p, int scheme, int row_group,
    int ranges, int cluster, int clash_bits, int blocks, int threads,
    int smem_bytes, void* stream) {
  return worp_countsketch_update_det_cluster_packed(
      values, nullptr, seeds, tseeds, base_keys, lengths, block_ends,
      workspace, delta, B, n, rows, width, chunk, has_p, neg_inv_p, scheme,
      row_group, ranges, cluster, clash_bits, blocks, threads, smem_bytes,
      stream);
}

// Registers, static shared memory, blocks per SM, dynamic shared memory
// and active clusters (worp::cluster_info) of the cluster kernel whose
// CTAs own row groups (split 1) or bucket ranges (2) `span` buckets wide.
extern "C" int worp_countsketch_update_cluster_info(int span, int split,
                                                    int cluster, int threads,
                                                    int smem_bytes,
                                                    int* out) {
  return worp::cluster_info(det_cluster_kernel(span, split), threads,
                            smem_bytes, cluster, out);
}

// The shared-memory variant: `blocks` blocks of `threads` threads and
// `smem_bytes` (rows x width x 4) of dynamic shared memory; block_ends is
// null for one block per stream (delta written whole), else the (B,)
// inclusive prefix sum of chunk counts (delta zeroed by the caller).
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int worp_countsketch_update_smem_packed(
    const void* values, const void* offsets, const void* seeds,
    const void* tseeds, const void* base_keys, const void* lengths,
    const void* block_ends, void* delta, int B, int n, int rows, int width,
    int chunk, int has_p, float neg_inv_p, int scheme, int blocks,
    int threads, int smem_bytes, void* stream) {
  const int err = worp::prepare_table_kernel(countsketch_update_smem,
                                             smem_bytes);
  if (err) return err;
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(block_ends),
      static_cast<float*>(delta), B, n, rows, width, chunk, has_p, scheme,
      neg_inv_p, 0, 0, static_cast<const int64_t*>(offsets)};
  countsketch_update_smem<<<blocks, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values),
      static_cast<const int32_t*>(base_keys), args);
  return static_cast<int>(cudaGetLastError());
}

// The shared-memory entry on (B, n) rows of values.
extern "C" int worp_countsketch_update_smem(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, const void* block_ends,
    void* delta, int B, int n, int rows, int width, int chunk, int has_p,
    float neg_inv_p, int scheme, int blocks, int threads, int smem_bytes,
    void* stream) {
  return worp_countsketch_update_smem_packed(
      values, nullptr, seeds, tseeds, base_keys, lengths, block_ends, delta,
      B, n, rows, width, chunk, has_p, neg_inv_p, scheme, blocks, threads,
      smem_bytes, stream);
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (global atomics), 1 (shared memory), 2
// (deterministic), 3 (deterministic, owning row groups) or 4 (owning bucket
// ranges).
extern "C" int worp_countsketch_update_info(int variant, int threads,
                                            int smem_bytes, int* out) {
  if (variant >= 2) {
    const auto kernel = det_kernel(variant - 2);
    const int err = worp::prepare_table_kernel(kernel, smem_bytes);
    if (err) return err;
    return worp::kernel_info(kernel, threads, smem_bytes, out);
  }
  if (variant == 1) {
    const int err = worp::prepare_table_kernel(countsketch_update_smem,
                                               smem_bytes);
    if (err) return err;
    return worp::kernel_info(countsketch_update_smem, threads, smem_bytes,
                             out);
  }
  return worp::kernel_info(countsketch_update_kernel, threads, smem_bytes,
                           out);
}

// The global-atomic variant: one thread per slot, `blocks` x `threads`
// covering B * n.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int worp_countsketch_update_packed(
    const void* values, const void* offsets, const void* seeds,
    const void* tseeds, const void* base_keys, const void* lengths,
    void* delta, int B, int n, int rows, int width, int has_p,
    float neg_inv_p, int scheme, int blocks, int threads, void* stream) {
  countsketch_update_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(base_keys),
      static_cast<const int32_t*>(lengths),
      static_cast<const int64_t*>(offsets), static_cast<float*>(delta), B, n,
      rows, width, has_p, neg_inv_p, scheme);
  return static_cast<int>(cudaGetLastError());
}

// The global-atomic entry on (B, n) rows of values.
extern "C" int worp_countsketch_update(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme, int blocks,
    int threads, void* stream) {
  return worp_countsketch_update_packed(values, nullptr, seeds, tseeds,
                                        base_keys, lengths, delta, B, n,
                                        rows, width, has_p, neg_inv_p, scheme,
                                        blocks, threads, stream);
}

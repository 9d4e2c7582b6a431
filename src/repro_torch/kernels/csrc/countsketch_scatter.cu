// Batched turnstile CountSketch scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/countsketch_scatter.py::countsketch_scatter_batched
// (a one-hot MXU matmul per width block, because the TPU has no atomics).
//
// Computes, for B streams of n signed (key, value) slots, the sketch delta
//   delta[b, r, hash(key, row_salt(seed_b, r)) % W] += sign_r(key) * v'
// where v' = v * r_x^{-1/p} with r_x = Exp1 (ppswor) or U(0,1] (priority)
// when has_p, else v' = v.  Slot (b, i) counts only when i < lengths[b] and
// key != -1.
//
// Three entries, chosen by the deterministic mode and the shape before the
// launch (kernels/tiling.py table_plan), never by a failed launch:
//   * worp_countsketch_scatter_smem, where the rows x width table fits a
//     block's shared memory (rows 7 with width <= 8192): one block per
//     (stream, chunk), the table in shared memory, the block body and its
//     flush in smem_table.cuh.  At the sparse plane's deployment (B = 4096
//     streams of n = 5120, 7 x 2048) each stream is one block, which writes
//     its 57 KB delta with plain stores into a torch.empty delta: no
//     zeroing pass and no global atomics.
//   * worp_countsketch_scatter, for larger tables: one thread per (b, i)
//     slot, the mask, the transform once, then rows global atomicAdds into
//     a zeroed delta.
//   * worp_countsketch_scatter_det, under
//     torch.use_deterministic_algorithms(True): one block per stream where
//     the table and two 256-slot stages fit a block, producer warps
//     hashing each stage once and one walker warp a row adding it, each
//     cell summed in an order fixed by the slot indices
//     (smem_table.cuh det_table_block), so every run gives the same bits.
//     A larger table is split (tiling.det_split): a block for each row
//     group of a stream, or for each bucket range of a row where one row
//     does not fit, each with the bits one whole-table block would give.
//   * worp_countsketch_scatter_det_cluster, the same mode on a table whose
//     row groups of one row fit three CTAs an SM (tiling.det_cluster, e.g.
//     fleet_serve --topk 400's 5 x 12,400): a thread block cluster a
//     stream, each CTA a row, the stream's slots hashed once a cluster
//     and pushed to the CTAs that own their cells (smem_table.cuh
//     det_cluster_block), the same bits.  At the flush's 4096 streams
//     it takes 1.633-1.635 ms raw where the blocks took 1.879-1.881 ms
//     (2.026 ms through the wrapper, the mode's NaN fill of the 1.0 GB
//     delta included); at 7 x 16,384 (two CTAs an SM) 3.018-3.019 ms
//     against the blocks' 2.775-2.776, and at 1 x 100,000 on 64 streams
//     (bucket ranges) 0.0475-0.0477 against 0.0438-0.0440, so those keep
//     the blocks (chip_smoke.py --det-parent, H100 80GB HBM3, 700.00 W).
// The first two sum in an order that changes from run to run, so the
// result matches the plain version within float tolerance, not bit for
// bit; so does the third (its order is fixed, but not the plain
// version's).
//
// Budget: 57,344 B of shared memory a block at the defaults and 32
// registers a thread, so 4 blocks of 512 threads an SM (chip_smoke.py
// prints both).  The bucket of a power-of-two width is hash & (W - 1), bit
// for bit hash % W (hashing.cuh).
//
// Bound: per live slot, 7 rows x (two hash_u32 + a mask) plus the
// transform's hash, log and pow: some 360 32-bit operations against 8 bytes
// read a slot and each stream's 57 KB table written once, so at the
// deployment the integer issue rate bounds it (0.449 ms, PERF.md), not
// device-memory bytes (0.12 ms).  The global-atomic design ran 147 M
// atomics to L2 in 2.06-2.61 ms (H100 80GB HBM3, 700.00 W).  Zipf keys put
// about 18 % of a stream's slots on key 0, so a warp's lanes often add to
// the same 7 cells.  A shared-memory float atomicAdd is a compare-and-swap
// loop on this card, so k lanes on one cell retry k times in turn: with
// each lane adding alone, a stream of one key (chip_smoke.py's hot-key
// cell) took 4.21 ms against the Zipf deployment's 0.877 ms, more than all
// the hashing.  So the scatter combines a warp's lanes that hold one key
// (__match_any_sync, then a shuffle sum to the lowest lane), which alone
// hashes the key and makes the 7 shared-memory adds (smem_table.cuh
// combine_lanes).  With it the deployment took 0.645 ms, 70 % of its bound
// (1.178 ms when lanes were matched cell by cell in every row), and the
// hot-key cell 0.538 ms; the global variant 2.056 ms (chip_smoke.py, H100
// 80GB HBM3, 700.00 W).
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"
#include "smem_table.cuh"

namespace {

__global__ void countsketch_scatter_kernel(
    const int32_t* __restrict__ keys, const float* __restrict__ values,
    const int32_t* __restrict__ seeds, const int32_t* __restrict__ tseeds,
    const int32_t* __restrict__ lengths, float* __restrict__ delta, int B,
    int n, int rows, int width, int has_p, float neg_inv_p, int scheme) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * n) return;
  const int b = static_cast<int>(idx / n);
  const int i = static_cast<int>(idx - static_cast<int64_t>(b) * n);
  const int32_t key = keys[idx];
  if (i >= lengths[b] || key == -1) return;

  const uint32_t k = static_cast<uint32_t>(key);
  float v = values[idx];
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
    countsketch_scatter_smem(const int32_t* __restrict__ keys,
                             const float* __restrict__ values,
                             worp::TableArgs args) {
  extern __shared__ float table[];
  worp::table_block(worp::SparseSlots{keys, values}, args, table);
}

// Entry: a row's staged bucket and sign, 16 bits where a block's rows span
// at most 2**15 buckets; kSplit: a block owns the whole table
// (worp::kDetWhole), a row group (kDetRows) or a bucket range of one row
// (kDetRanges).
template <class Entry, int kSplit>
__global__ void __launch_bounds__(worp::kTableThreads, 3)
    countsketch_scatter_det(const int32_t* __restrict__ keys,
                            const float* __restrict__ values,
                            worp::TableArgs args) {
  extern __shared__ float table[];
  worp::det_table_block<worp::SparseSlots, Entry, kSplit>(
      worp::SparseSlots{keys, values}, args, table);
}

// A CTA of a det cluster (tiling.det_cluster): a table too large for one
// block spread over the cluster's shared memory, each slot hashed once.
// Bucket: 16 bits where a CTA's rows span at most 2**16 buckets; kSplit:
// the CTA owns a row group (worp::kDetRows) or a bucket range of one row
// (kDetRanges).
template <class Bucket, int kSplit>
__global__ void __launch_bounds__(worp::kTableThreads, 2)
    countsketch_scatter_det_cluster(const int32_t* __restrict__ keys,
                                    const float* __restrict__ values,
                                    worp::TableArgs args, int clash_bits) {
  extern __shared__ float table[];
  worp::det_cluster_block<worp::SparseSlots, Bucket, kSplit>(
      worp::SparseSlots{keys, values}, args, clash_bits, table);
}

using DetKernel = void (*)(const int32_t*, const float*, worp::TableArgs);
using ClusterKernel = void (*)(const int32_t*, const float*,
                               worp::TableArgs, int);

// The cluster kernel of CTAs owning `split` (row groups or bucket ranges)
// whose rows span `span` buckets.
ClusterKernel det_cluster_kernel(int span, int split) {
  if (span <= (1 << 16)) {
    return split == worp::kDetRanges
               ? countsketch_scatter_det_cluster<uint16_t, worp::kDetRanges>
               : countsketch_scatter_det_cluster<uint16_t, worp::kDetRows>;
  }
  return split == worp::kDetRanges
             ? countsketch_scatter_det_cluster<uint32_t, worp::kDetRanges>
             : countsketch_scatter_det_cluster<uint32_t, worp::kDetRows>;
}

template <class Entry>
DetKernel det_kernel_of(int split) {
  if (split == worp::kDetRanges) {
    return countsketch_scatter_det<Entry, worp::kDetRanges>;
  }
  if (split == worp::kDetRows) {
    return countsketch_scatter_det<Entry, worp::kDetRows>;
  }
  return countsketch_scatter_det<Entry, worp::kDetWhole>;
}

// The det kernel's instantiation for blocks whose rows span `span` buckets
// (the width, or a bucket range's) and own a part of the table `split`.
DetKernel det_kernel(int span, int split) {
  return span <= (1 << 15) ? det_kernel_of<uint16_t>(split)
                           : det_kernel_of<uint32_t>(split);
}

// The split of a launch: bucket ranges, row groups, or none.
int det_split(int row_group, int ranges) {
  return ranges > 1       ? worp::kDetRanges
         : row_group > 0 ? worp::kDetRows
                         : worp::kDetWhole;
}

}  // namespace

// The deterministic variant: `blocks` blocks of `threads` (32 x (8
// producer warps + min(rows of a block, 8) walkers)), `smem_bytes`
// (tiling.det_smem_bytes of a block's rows) of dynamic shared memory: B
// blocks, one a stream, or, split (tiling.det_split), B x parts, each
// stream's parts row groups of `row_group` rows or, where ranges > 1,
// `ranges` bucket ranges of each row.  The delta is written whole.
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int worp_countsketch_scatter_det(
    const void* keys, const void* values, const void* seeds,
    const void* tseeds, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme,
    int row_group, int ranges, int blocks, int threads, int smem_bytes,
    void* stream) {
  const auto kernel = det_kernel(
      ranges > 1 ? (width + ranges - 1) / ranges : width,
      det_split(row_group, ranges));
  const int err = worp::prepare_table_kernel(kernel, smem_bytes);
  if (err) return err;
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      nullptr,
      static_cast<float*>(delta), B, n, rows, width, 0, has_p, scheme,
      neg_inv_p, row_group, ranges};
  kernel<<<blocks, threads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(values),
      args);
  return static_cast<int>(cudaGetLastError());
}

// The deterministic variant over thread block clusters (tiling.
// det_cluster): `blocks` CTAs of `threads` (32 x (8 producer warps +
// min(rows of a CTA, 8) walkers)) and `smem_bytes` (tiling.
// det_cluster_smem_bytes), in clusters of `cluster` CTAs, one a stream;
// each CTA owns a row group of `row_group` rows or, where ranges > 1, one
// of `ranges` bucket ranges of a row, its producer warps' clash bitmaps
// `clash_bits` bits each (tiling.det_clash_bits).  The delta is written
// whole.  Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int worp_countsketch_scatter_det_cluster(
    const void* keys, const void* values, const void* seeds,
    const void* tseeds, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme,
    int row_group, int ranges, int cluster, int clash_bits, int blocks,
    int threads, int smem_bytes, void* stream) {
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      nullptr,
      static_cast<float*>(delta), B, n, rows, width, 0, has_p, scheme,
      neg_inv_p, row_group, ranges};
  return worp::launch_cluster(
      det_cluster_kernel(ranges > 1 ? (width + ranges - 1) / ranges : width,
                         det_split(row_group, ranges)),
      blocks, threads, smem_bytes, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(keys),
      static_cast<const float*>(values), args, clash_bits);
}

// Registers, static shared memory, blocks per SM, dynamic shared memory
// and active clusters (worp::cluster_info) of the cluster kernel whose
// CTAs own row groups (split 1) or bucket ranges (2) `span` buckets wide.
extern "C" int worp_countsketch_scatter_cluster_info(int span, int split,
                                                     int cluster,
                                                     int threads,
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
extern "C" int worp_countsketch_scatter_smem(
    const void* keys, const void* values, const void* seeds,
    const void* tseeds, const void* lengths, const void* block_ends,
    void* delta, int B, int n, int rows, int width, int chunk, int has_p,
    float neg_inv_p, int scheme, int blocks, int threads, int smem_bytes,
    void* stream) {
  const int err = worp::prepare_table_kernel(countsketch_scatter_smem,
                                             smem_bytes);
  if (err) return err;
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(block_ends),
      static_cast<float*>(delta), B, n, rows, width, chunk, has_p, scheme,
      neg_inv_p};
  countsketch_scatter_smem<<<blocks, threads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(values),
      args);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (global atomics), 1 (shared memory), 2
// (deterministic, width <= 2**15), 3 (deterministic, 32-bit entries), 4
// or 5 (the same owning row groups), 6 or 7 (owning bucket ranges).
extern "C" int worp_countsketch_scatter_info(int variant, int threads,
                                             int smem_bytes, int* out) {
  if (variant >= 2) {
    const auto kernel = det_kernel(variant % 2 == 0 ? 1 : (1 << 15) + 1,
                                   (variant - 2) / 2);
    const int err = worp::prepare_table_kernel(kernel, smem_bytes);
    if (err) return err;
    return worp::kernel_info(kernel, threads, smem_bytes, out);
  }
  if (variant == 1) {
    const int err = worp::prepare_table_kernel(countsketch_scatter_smem,
                                               smem_bytes);
    if (err) return err;
    return worp::kernel_info(countsketch_scatter_smem, threads, smem_bytes,
                             out);
  }
  return worp::kernel_info(countsketch_scatter_kernel, threads, smem_bytes,
                           out);
}

// The global-atomic variant: one thread per slot, `blocks` x `threads`
// covering B * n.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int worp_countsketch_scatter(
    const void* keys, const void* values, const void* seeds,
    const void* tseeds, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme, int blocks,
    int threads, void* stream) {
  countsketch_scatter_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(values),
      static_cast<const int32_t*>(seeds), static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths), static_cast<float*>(delta), B, n,
      rows, width, has_p, neg_inv_p, scheme);
  return static_cast<int>(cudaGetLastError());
}

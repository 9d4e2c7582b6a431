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
//     torch.use_deterministic_algorithms(True) where the table and a
//     1024-slot stage fit a block: one block per stream, one warp per row,
//     each cell summed in an order fixed by slot index
//     (smem_table.cuh det_table_block), so every run gives the same bits.
//     A larger table has no deterministic variant: the wrapper raises.
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

__global__ void __launch_bounds__(worp::kTableThreads)
    countsketch_scatter_det(const int32_t* __restrict__ keys,
                            const float* __restrict__ values,
                            worp::TableArgs args) {
  extern __shared__ float table[];
  worp::det_table_block(worp::SparseSlots{keys, values}, args, table);
}

}  // namespace

// The deterministic variant: one block of `threads` (32 a row, at most
// 512) per stream, `smem_bytes` (rows x width x 4 + kDetTile x 8) of
// dynamic shared memory, the delta written whole.  Launches on `stream`;
// returns a CUDA error code (0 on success).
extern "C" int worp_countsketch_scatter_det(
    const void* keys, const void* values, const void* seeds,
    const void* tseeds, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme, int threads,
    int smem_bytes, void* stream) {
  const int err = worp::prepare_table_kernel(countsketch_scatter_det,
                                             smem_bytes);
  if (err) return err;
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      nullptr,
      static_cast<float*>(delta), B, n, rows, width, 0, has_p, scheme,
      neg_inv_p};
  countsketch_scatter_det<<<B, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(values),
      args);
  return static_cast<int>(cudaGetLastError());
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
// (worp::kernel_info) of variant 0 (global atomics), 1 (shared memory) or
// 2 (deterministic).
extern "C" int worp_countsketch_scatter_info(int variant, int threads,
                                             int smem_bytes, int* out) {
  if (variant == 2) {
    const int err = worp::prepare_table_kernel(countsketch_scatter_det,
                                               smem_bytes);
    if (err) return err;
    return worp::kernel_info(countsketch_scatter_det, threads, smem_bytes,
                             out);
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

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
//
// Budget: 57,344 B of shared memory a block at the defaults and 31
// registers a thread, so 4 blocks of 512 threads an SM (chip_smoke.py
// prints both).  The bucket of a power-of-two width is hash & (W - 1), bit
// for bit hash % W (hashing.cuh).
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
// 80GB HBM3, 700.00 W).
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"
#include "smem_table.cuh"

namespace {

__global__ void countsketch_update_kernel(
    const float* __restrict__ values, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ tseeds, const int32_t* __restrict__ base_keys,
    const int32_t* __restrict__ lengths, float* __restrict__ delta, int B,
    int n, int rows, int width, int has_p, float neg_inv_p, int scheme) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * n) return;
  const int b = static_cast<int>(idx / n);
  const int i = static_cast<int>(idx - static_cast<int64_t>(b) * n);
  if (i >= lengths[b]) return;

  const uint32_t k =
      static_cast<uint32_t>(base_keys[b]) + static_cast<uint32_t>(i);
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
    countsketch_update_smem(const float* __restrict__ values,
                            const int32_t* __restrict__ base_keys,
                            worp::TableArgs args) {
  extern __shared__ float table[];
  worp::table_block(worp::DenseSlots{values, base_keys}, args, table);
}

}  // namespace

// The shared-memory variant: `blocks` blocks of `threads` threads and
// `smem_bytes` (rows x width x 4) of dynamic shared memory; block_ends is
// null for one block per stream (delta written whole), else the (B,)
// inclusive prefix sum of chunk counts (delta zeroed by the caller).
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int worp_countsketch_update_smem(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, const void* block_ends,
    void* delta, int B, int n, int rows, int width, int chunk, int has_p,
    float neg_inv_p, int scheme, int blocks, int threads, int smem_bytes,
    void* stream) {
  const int err = worp::prepare_table_kernel(countsketch_update_smem,
                                             smem_bytes);
  if (err) return err;
  const worp::TableArgs args{
      static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(block_ends),
      static_cast<float*>(delta), B, n, rows, width, chunk, has_p, scheme,
      neg_inv_p};
  countsketch_update_smem<<<blocks, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values),
      static_cast<const int32_t*>(base_keys), args);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (global atomics) or 1 (shared memory).
extern "C" int worp_countsketch_update_info(int variant, int threads,
                                            int smem_bytes, int* out) {
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
extern "C" int worp_countsketch_update(
    const void* values, const void* seeds, const void* tseeds,
    const void* base_keys, const void* lengths, void* delta, int B, int n,
    int rows, int width, int has_p, float neg_inv_p, int scheme, int blocks,
    int threads, void* stream) {
  countsketch_update_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(tseeds),
      static_cast<const int32_t*>(base_keys),
      static_cast<const int32_t*>(lengths), static_cast<float*>(delta), B, n,
      rows, width, has_p, neg_inv_p, scheme);
  return static_cast<int>(cudaGetLastError());
}

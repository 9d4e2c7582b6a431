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
// lengths to [0, n]); no key is padding, so key 0xFFFFFFFF is sketched.  The
// caller zeroes delta.
//
// Design: one thread per (b, i) slot, as the scatter kernel.  The key is
// computed, not loaded; a dead slot returns before it loads its value.  A
// live slot computes the transform once, then walks the rows and atomically
// adds sign * v' into the global (B, rows, W) delta.  Float atomics sum in
// an order that changes from run to run, so the result matches the plain
// version within float tolerance, not bit for bit.
//
// Bound: per live slot, 7 rows x (two hash_u32 + a modulo) plus the
// transform's hash, log and pow, some 358 32-bit operations, against 4 bytes
// read: the kernel is bound by integer issue rate, not by device-memory
// bytes.  Dense keys are distinct, so unlike the Zipf-headed scatter no
// bucket is hot; contention is only the even load of about n / W atomics per
// cell (at one gemma2_2b layer, 21.2 M / 2048 = 10 k per row of a wg
// stream), all going to L2.  The next step is one block per (stream, chunk)
// privatising the 7 x 2048 x 4 B = 57 KB table in shared memory, with one
// flush of it per block.
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"

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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
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

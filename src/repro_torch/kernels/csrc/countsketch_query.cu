// Batched CountSketch query (signed per-row reads) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/countsketch_query.py::countsketch_query_batched
// (a one-hot MXU contraction over width blocks, the TPU's form of a gather).
//
// Computes out[b, r, j] = tables[b, r, hash(key, row_salt(seed_b, r)) % W]
//                         * sign_r(key)      for key = keys[b, j],
// each stream against its own table and seed.  The median over rows stays
// outside the kernel (jnp.median semantics, in PyTorch).
//
// Design: a real gather, one thread per (b, j) key.  The thread hashes its
// key once per row, reads one float and writes it signed; consecutive
// threads write consecutive j, so the (B, rows, k) output is coalesced.  The
// product with +-1 is exact, so the result equals the plain version bit for
// bit.
//
// Bound: per key, 7 rows x (two hash_u32 + a mask, hashing.cuh's bucket of
// a power-of-two width; a modulo otherwise), some 420 integer
// operations, against 4 B of key read, 7 random 4 B table reads (whole
// 32 B sectors move) and 28 B written.  At the deployment shape the integer
// work and the (B, rows, k) output write weigh about alike; fusing the
// median into the kernel would cut the output 7x and is the next step.
#include <cstdint>

#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"

namespace {

__global__ void countsketch_query_kernel(const float* __restrict__ tables,
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
  for (int r = 0; r < rows; ++r) {
    const uint32_t salt = worp::row_salt(seed, static_cast<uint32_t>(r));
    const uint32_t bucket =
        worp::bucket_hash(key, salt, static_cast<uint32_t>(width));
    dst[static_cast<int64_t>(r) * k] =
        table[static_cast<int64_t>(r) * width + bucket] *
        worp::sign_hash(key, salt);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int worp_countsketch_query(const void* tables, const void* keys,
                                      const void* seeds, void* out, int B,
                                      int k, int rows, int width, int blocks,
                                      int threads, void* stream) {
  countsketch_query_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(seeds), static_cast<float*>(out), B, k,
      rows, width);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of the query kernel at `threads` threads.
extern "C" int worp_countsketch_query_info(int variant, int threads,
                                           int smem_bytes, int* out) {
  return worp::kernel_info(countsketch_query_kernel, threads, smem_bytes,
                           out);
}

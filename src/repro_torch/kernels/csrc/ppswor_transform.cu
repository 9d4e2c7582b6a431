// Standalone p-ppswor transform (Eq. 5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ppswor_transform.py::ppswor_transform
// (an element-wise VPU pass over (1, block_n) tiles).
//
// Computes out[i] = values[i] * Exp1(hash(keys[i], tseed))^(-1/p) in the
// values' type:
//   float32   v * powf(-logf(u), -1/p), as the fused transform of the
//             sketch kernels (hashing.cuh);
//   bfloat16  as the Pallas kernel: the factor is computed in float32 and
//             rounded to bfloat16, and the product of the two bfloat16
//             values (exact in float32) is rounded to bfloat16.
//
// Design: one thread per element, consecutive threads on consecutive
// elements, so every load and store is coalesced.  The factor is the same
// hash, log and pow as the sketch kernels', from hashing.cuh, so it is bit
// for bit the uniform variate of the plain version and within a few ulps of
// its -log and pow.
//
// Bound: per element one hash_u32 and the uniform (some 24 32-bit
// operations), a log, a pow and a multiply, against 4 bytes of key, 4 (or 2)
// bytes of value read and 4 (or 2) written: at 3.35 TB/s the bytes bound it
// (about 0.076 ms for 21.2 M float32 elements), and the operations take
// half of that time at the card's integer rate.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"

namespace {

__global__ void ppswor_transform_f32(const int32_t* __restrict__ keys,
                                     const float* __restrict__ values,
                                     float* __restrict__ out, int n,
                                     uint32_t tseed, float neg_inv_p) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float f = worp::transform_factor(static_cast<uint32_t>(keys[i]),
                                         tseed, worp::kPpswor, neg_inv_p);
  out[i] = __fmul_rn(values[i], f);
}

__global__ void ppswor_transform_bf16(const int32_t* __restrict__ keys,
                                      const __nv_bfloat16* __restrict__ values,
                                      __nv_bfloat16* __restrict__ out, int n,
                                      uint32_t tseed, float neg_inv_p) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float f = worp::transform_factor(static_cast<uint32_t>(keys[i]),
                                         tseed, worp::kPpswor, neg_inv_p);
  const float fb = __bfloat162float(__float2bfloat16_rn(f));
  out[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(values[i]), fb));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int worp_ppswor_transform(const void* keys, const void* values,
                                     void* out, int n, int tseed,
                                     float neg_inv_p, int dtype, int blocks,
                                     int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t ts = static_cast<uint32_t>(tseed);
  if (dtype == 1) {
    ppswor_transform_bf16<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(keys),
        static_cast<const __nv_bfloat16*>(values),
        static_cast<__nv_bfloat16*>(out), n, ts, neg_inv_p);
  } else {
    ppswor_transform_f32<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(values),
        static_cast<float*>(out), n, ts, neg_inv_p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (float32) or 1 (bfloat16).
extern "C" int worp_ppswor_transform_info(int variant, int threads,
                                          int smem_bytes, int* out) {
  if (variant == 1) {
    return worp::kernel_info(ppswor_transform_bf16, threads, smem_bytes, out);
  }
  return worp::kernel_info(ppswor_transform_f32, threads, smem_bytes, out);
}

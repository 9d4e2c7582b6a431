// Standalone p-ppswor transform (Eq. 5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ppswor_transform.py::ppswor_transform
// (an element-wise VPU pass over (1, block_n) tiles).
//
// Computes out[i] = values[i] * Exp1(hash(keys[i], tseed))^(-1/p) in the
// values' type:
//   float32   v * r^(-1/p) with r = -logf(u), as the fused transform of
//             the sketch kernels (hashing.cuh);
//   bfloat16  as the Pallas kernel: the factor is computed in float32 and
//             rounded to bfloat16, and the product of the two bfloat16
//             values (exact in float32) is rounded to bfloat16.
//
// Two variants, chosen by the wrapper before the launch:
//   vector  each thread takes 4 float32 or 8 bfloat16 elements with 16-byte
//           loads and stores, over a grid-stride loop sized to the card;
//           the last n % 4 (or n % 8) elements go one a thread.  Needs every
//           pointer 16-byte aligned.
//   scalar  one thread per element (any alignment).
// Consecutive threads take consecutive elements, so every access is
// coalesced.  The factor is hashing.cuh's: bit for bit the uniform variate
// of the plain version, and within a few ulps of its -log and power.
//
// Bound: 4 bytes of key, 4 (or 2) of value read and 4 (or 2) written an
// element: 255 MB (170 MB) at 21.2 M elements, 0.076 ms (0.051 ms) at
// 3.35 TB/s.  The instructions of an element are not one operation each:
// the hash and the uniform are some 24, but a full-precision -logf is a
// range reduction around MUFU.LG2, and a general powf an extended-precision
// log2 and exp2, dozens more.  At p = 1, 2 and 0.5 the power is one
// correctly rounded reciprocal or reciprocal square root (hashing.cuh),
// which brings the work an element under its bytes' time.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kernel_info.cuh"

namespace {

__device__ __forceinline__ float factor(int32_t key, uint32_t tseed,
                                        float neg_inv_p) {
  return worp::transform_factor(static_cast<uint32_t>(key), tseed,
                                worp::kPpswor, neg_inv_p);
}

// v * f rounded as the Pallas kernel does in bfloat16 (the header above).
__device__ __forceinline__ float bf16_product(float v, float f) {
  const float fb = __bfloat162float(__float2bfloat16_rn(f));
  return __fmul_rn(v, fb);
}

// The two bfloat16 values packed in w (element 0 in the low half) as
// float32, exactly.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__global__ void ppswor_transform_f32(const int32_t* __restrict__ keys,
                                     const float* __restrict__ values,
                                     float* __restrict__ out, int n,
                                     uint32_t tseed, float neg_inv_p) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __fmul_rn(values[i], factor(keys[i], tseed, neg_inv_p));
}

__global__ void ppswor_transform_bf16(const int32_t* __restrict__ keys,
                                      const __nv_bfloat16* __restrict__ values,
                                      __nv_bfloat16* __restrict__ out, int n,
                                      uint32_t tseed, float neg_inv_p) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __float2bfloat16_rn(bf16_product(
      __bfloat162float(values[i]), factor(keys[i], tseed, neg_inv_p)));
}

__global__ void ppswor_transform_f32_vec(const int32_t* __restrict__ keys,
                                         const float* __restrict__ values,
                                         float* __restrict__ out, int n,
                                         uint32_t tseed, float neg_inv_p) {
  const int64_t nvec = n / 4;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  const float4* v4 = reinterpret_cast<const float4*>(values);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t i = first; i < nvec; i += stride) {
    const int4 k = k4[i];
    const float4 v = v4[i];
    float4 o;
    o.x = __fmul_rn(v.x, factor(k.x, tseed, neg_inv_p));
    o.y = __fmul_rn(v.y, factor(k.y, tseed, neg_inv_p));
    o.z = __fmul_rn(v.z, factor(k.z, tseed, neg_inv_p));
    o.w = __fmul_rn(v.w, factor(k.w, tseed, neg_inv_p));
    o4[i] = o;
  }
  const int64_t t = nvec * 4 + first;  // the tail, one element a thread
  if (t < n) out[t] = __fmul_rn(values[t], factor(keys[t], tseed, neg_inv_p));
}

__global__ void ppswor_transform_bf16_vec(
    const int32_t* __restrict__ keys, const __nv_bfloat16* __restrict__ values,
    __nv_bfloat16* __restrict__ out, int n, uint32_t tseed, float neg_inv_p) {
  const int64_t nvec = n / 8;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  const uint4* v8 = reinterpret_cast<const uint4*>(values);
  uint4* o8 = reinterpret_cast<uint4*>(out);
  for (int64_t i = first; i < nvec; i += stride) {
    const int4 ka = k4[2 * i];
    const int4 kb = k4[2 * i + 1];
    const uint4 v = v8[i];
    uint4 o;
    o.x = bf16_pack(bf16_product(bf16_lo(v.x), factor(ka.x, tseed, neg_inv_p)),
                    bf16_product(bf16_hi(v.x), factor(ka.y, tseed, neg_inv_p)));
    o.y = bf16_pack(bf16_product(bf16_lo(v.y), factor(ka.z, tseed, neg_inv_p)),
                    bf16_product(bf16_hi(v.y), factor(ka.w, tseed, neg_inv_p)));
    o.z = bf16_pack(bf16_product(bf16_lo(v.z), factor(kb.x, tseed, neg_inv_p)),
                    bf16_product(bf16_hi(v.z), factor(kb.y, tseed, neg_inv_p)));
    o.w = bf16_pack(bf16_product(bf16_lo(v.w), factor(kb.z, tseed, neg_inv_p)),
                    bf16_product(bf16_hi(v.w), factor(kb.w, tseed, neg_inv_p)));
    o8[i] = o;
  }
  const int64_t t = nvec * 8 + first;
  if (t < n) {
    out[t] = __float2bfloat16_rn(bf16_product(
        __bfloat162float(values[t]), factor(keys[t], tseed, neg_inv_p)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vector: 1 for the 16-byte variant
// (every pointer 16-byte aligned, the wrapper checks), 0 for one thread an
// element.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int worp_ppswor_transform(const void* keys, const void* values,
                                     void* out, int n, int tseed,
                                     float neg_inv_p, int dtype, int vector,
                                     int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t ts = static_cast<uint32_t>(tseed);
  const int32_t* k = static_cast<const int32_t*>(keys);
  if (dtype == 1) {
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(values);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vector) {
      ppswor_transform_bf16_vec<<<blocks, threads, 0, s>>>(k, v, o, n, ts,
                                                          neg_inv_p);
    } else {
      ppswor_transform_bf16<<<blocks, threads, 0, s>>>(k, v, o, n, ts,
                                                      neg_inv_p);
    }
  } else {
    const float* v = static_cast<const float*>(values);
    float* o = static_cast<float*>(out);
    if (vector) {
      ppswor_transform_f32_vec<<<blocks, threads, 0, s>>>(k, v, o, n, ts,
                                                         neg_inv_p);
    } else {
      ppswor_transform_f32<<<blocks, threads, 0, s>>>(k, v, o, n, ts,
                                                     neg_inv_p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info) of variant 0 (float32), 1 (bfloat16), 2 (float32
// vector) or 3 (bfloat16 vector).
extern "C" int worp_ppswor_transform_info(int variant, int threads,
                                          int smem_bytes, int* out) {
  switch (variant) {
    case 1:
      return worp::kernel_info(ppswor_transform_bf16, threads, smem_bytes,
                               out);
    case 2:
      return worp::kernel_info(ppswor_transform_f32_vec, threads, smem_bytes,
                               out);
    case 3:
      return worp::kernel_info(ppswor_transform_bf16_vec, threads, smem_bytes,
                               out);
    default:
      return worp::kernel_info(ppswor_transform_f32, threads, smem_bytes,
                               out);
  }
}

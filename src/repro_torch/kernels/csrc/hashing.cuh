// Seed-keyed hashing shared by the WORp CUDA kernels.
//
// A copy of the mixer and constants of repro/core/hashing.py (and of
// repro_torch/core/hashing.py), in native uint32_t arithmetic, so a key
// lands in the same bucket with the same sign and the same Exp[1] variate
// on the card as in either Python package.  Built without fast math: the
// uniform variate is exact, and -logf/powf stay within a few ulps of the
// host libraries.
#pragma once
#include <cstdint>

namespace worp {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kRowSalt = 0x9E3779B9u;
constexpr uint32_t kSignSalt = 0x85EBCA6Bu;
constexpr uint32_t kExpSalt = 0xC2B2AE35u;

// bottom-k randomizers (transforms.py): Exp[1] for ppswor, U(0,1] priority
constexpr int kPpswor = 0;
constexpr int kPriority = 1;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t key, uint32_t salt) {
  return mix32(mix32(key + salt) ^ (salt * kRowSalt));
}

__device__ __forceinline__ uint32_t row_salt(uint32_t seed, uint32_t row) {
  return seed + (row + 1u) * kRowSalt;
}

// Uniform(0, 1]: top 24 bits times 2^-24, plus 2^-25, each step rounded
// as float32 (the product is exact, so a fused multiply-add rounds alike).
__device__ __forceinline__ float uniform01(uint32_t key, uint32_t salt) {
  const uint32_t h = hash_u32(key, salt ^ kExpSalt);
  return __fadd_rn(__fmul_rn(static_cast<float>(h >> 8), 0x1p-24f), 0x1p-25f);
}

__device__ __forceinline__ float sign_hash(uint32_t key, uint32_t salt) {
  return (hash_u32(key, salt ^ kSignSalt) & 1u) ? -1.0f : 1.0f;
}

// hash % width.  For a power-of-two width the mask gives the same bucket
// bit for bit in one instruction, where a 32-bit modulo by a run-time width
// is a sequence of some twenty.
__device__ __forceinline__ uint32_t bucket_hash(uint32_t key, uint32_t salt,
                                                uint32_t width) {
  const uint32_t h = hash_u32(key, salt);
  return (width & (width - 1u)) == 0u ? h & (width - 1u) : h % width;
}

// r_x^{-1/p}, the factor of Eq. 5 in float32; neg_inv_p is -1/p rounded to
// float32 by the caller.
__device__ __forceinline__ float transform_factor(uint32_t key, uint32_t tseed,
                                                  int scheme,
                                                  float neg_inv_p) {
  const float u = uniform01(key, tseed);
  const float r = scheme == kPpswor ? -logf(u) : u;
  return powf(r, neg_inv_p);
}

// v / r_x^{1/p} (Eq. 5).
__device__ __forceinline__ float transform_value(float v, uint32_t key,
                                                 uint32_t tseed, int scheme,
                                                 float neg_inv_p) {
  return v * transform_factor(key, tseed, scheme, neg_inv_p);
}

}  // namespace worp

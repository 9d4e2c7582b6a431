// Seed-keyed hashing shared by the WORp CUDA kernels.
//
// A copy of the mixer and constants of repro/core/hashing.py (and of
// repro_torch/core/hashing.py), in native uint32_t arithmetic, so a key
// lands in the same bucket with the same sign and the same Exp[1] variate
// on the card as in either Python package.  Built without fast math: the
// uniform variate is exact, and -logf and the power stay within a few ulps
// of the host libraries.
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

// 1 where the key's sign in the row of `salt` is -1, else 0.
__device__ __forceinline__ uint32_t sign_bit(uint32_t key, uint32_t salt) {
  return hash_u32(key, salt ^ kSignSalt) & 1u;
}

__device__ __forceinline__ float sign_hash(uint32_t key, uint32_t salt) {
  return sign_bit(key, salt) ? -1.0f : 1.0f;
}

// sign_bit(key, salt) << 31, for an XOR into a float's sign.  The bit is
// bit 0 of x ^ (x >> 16), x the outer mixer's state before its last step;
// x * 0x80008000 = (x << 31) + (x << 15) holds x0 ^ x16 in bit 31, since
// nothing below bit 31 carries into it: one multiply (on the FMA pipe) and
// a mask in place of the last shift, the XOR and the bit tests.
__device__ __forceinline__ uint32_t sign_mask(uint32_t key, uint32_t salt) {
  const uint32_t s = salt ^ kSignSalt;
  uint32_t x = mix32(key + s) ^ (s * kRowSalt);
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  return (x * 0x80008000u) & 0x80000000u;
}

// hash % width.  For a power-of-two width the mask gives the same bucket
// bit for bit in one instruction, where a 32-bit modulo by a run-time width
// is a sequence of some twenty.
__device__ __forceinline__ uint32_t bucket_hash(uint32_t key, uint32_t salt,
                                                uint32_t width) {
  const uint32_t h = hash_u32(key, salt);
  return (width & (width - 1u)) == 0u ? h & (width - 1u) : h % width;
}

// r^e for the exponent e = -1/p of Eq. 5.  The exponents of p = 1, 2 and
// 0.5 are exact in float32 and take one correctly rounded intrinsic each
// (a reciprocal, a reciprocal square root, a square and a reciprocal) in
// place of powf's extended-precision log2 and exp2; the branch is uniform
// across a launch.  Each stays within an ulp of powf and keeps its
// infinities at r = -0.0 (the reference's uniform01 == 1.0 edge): -inf for
// e = -1, +inf for e = -0.5 (hence the fabsf: rsqrt(-0) is -inf) and -2.
// Every other exponent keeps powf.
__device__ __forceinline__ float pow_neg_inv_p(float r, float neg_inv_p) {
  if (neg_inv_p == -1.0f) return __frcp_rn(r);
  if (neg_inv_p == -0.5f) return __frsqrt_rn(fabsf(r));
  if (neg_inv_p == -2.0f) return __frcp_rn(__fmul_rn(r, r));
  return powf(r, neg_inv_p);
}

// r_x^{-1/p}, the factor of Eq. 5 in float32; neg_inv_p is -1/p rounded to
// float32 by the caller.
__device__ __forceinline__ float transform_factor(uint32_t key, uint32_t tseed,
                                                  int scheme,
                                                  float neg_inv_p) {
  const float u = uniform01(key, tseed);
  const float r = scheme == kPpswor ? -logf(u) : u;
  return pow_neg_inv_p(r, neg_inv_p);
}

// v / r_x^{1/p} (Eq. 5).
__device__ __forceinline__ float transform_value(float v, uint32_t key,
                                                 uint32_t tseed, int scheme,
                                                 float neg_inv_p) {
  return v * transform_factor(key, tseed, scheme, neg_inv_p);
}

}  // namespace worp

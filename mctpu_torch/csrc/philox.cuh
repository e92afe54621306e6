// The port's in-kernel random stream: Philox-4x32-10 keyed by the murmur3
// fold of the seed words, Box-Muller with the folded sin/cos polynomial.
//
// It is, bit for bit, the stream the JAX package's Pallas kernels draw in
// interpret mode (mctpu/kernels/common.py: seed_prng, _philox_words,
// draw_normal_pair; mctpu/rng.py: philox4x32, box_muller) and the stream of
// the port's plain versions (mctpu_torch/rng.py, kernels/common.py), so a
// kernel and its plain version see the same normals up to libm rounding.
#pragma once

#include <cstdint>

namespace mct {

// Float constants are written as double literals and rounded to float,
// exactly as the JAX kernels round their weakly-typed Python floats.
#define MCT_F32(x) static_cast<float>(x)

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1,
                                               uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// murmur3 finalizer (key setup only).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Key of seed_prng(w0, w1): the int32 words are read as u32.
struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ Key seed_key(uint32_t w0, uint32_t w1) {
  uint32_t k = 0x9E3779B9u;
  k = mix32(k ^ w0);
  k = mix32(k ^ w1);
  return Key{k, mix32(k ^ 0xBB67AE85u)};
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// (cos, sin) of 2*pi*bits/2^32: quadrant from the top two bits, degree-9/8
// polynomials in the remaining 30 (mctpu/rng.py, sincos_2pi_bits).
__device__ __forceinline__ void sincos_2pi_bits(uint32_t bits, float& cos_out,
                                                float& sin_out) {
  const uint32_t q = bits >> 30;
  const float x = uniform_from_bits(bits << 2);
  const float x2 = x * x;
  const float s =
      x * (MCT_F32(1.5707963220833954) +
           x2 * (MCT_F32(-0.6459638379804595) +
                 x2 * (MCT_F32(0.07969037160884318) +
                       x2 * (MCT_F32(-0.004674962479799562) +
                             x2 * MCT_F32(0.00015212572840063213)))));
  const float c =
      MCT_F32(0.9999999672205848) +
      x2 * (MCT_F32(-1.2336987443427399) +
            x2 * (MCT_F32(0.25365381634350864) +
                  x2 * (MCT_F32(-0.020816187054871052) +
                        x2 * MCT_F32(0.0008612789203638717))));
  const bool swap = (q & 1u) == 1u;
  const float cq = swap ? s : c;
  const float sq = swap ? c : s;
  cos_out = (q == 1u || q == 2u) ? -cq : cq;
  sin_out = (q >= 2u) ? -sq : sq;
}

// Both Box-Muller branches; u1 is mapped to (0, 1] so logf is finite.
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2, float& z1,
                                           float& z2) {
  const float u1 = 1.0f - uniform_from_bits(b1);
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  sincos_2pi_bits(b2, c, s);
  z1 = r * c;
  z2 = r * s;
}

// draw_normal_pair with tag 0: Philox block (elem, ctr, 0, 0) under key.
__device__ __forceinline__ void draw_normal_pair(Key key, uint32_t elem,
                                                 uint32_t ctr, float& z1,
                                                 float& z2) {
  const uint4 w = philox4x32_10(key.k0, key.k1, elem, ctr, 0u, 0u);
  box_muller(w.x, w.y, z1, z2);
}

}  // namespace mct

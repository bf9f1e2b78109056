// Threefry-2x32 (20 rounds) and the jax.random draws built on it, for
// Hopper. The plain torch version of every function here is in
// ops/threefry.py, which holds them bit for bit to jax.random (JAX 0.9,
// jax_threefry_partitionable on, 64-bit types off).
#pragma once

#include <stdint.h>

#define CW_KS_PARITY 0x1BD11BDAu

__device__ __forceinline__ uint32_t cw_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32 of the counter (c.x, c.y) under the key (k.x, k.y).
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint2 c) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ CW_KS_PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c.x + ks[0], x1 = c.y + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = cw_rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// Key i of jax.random.split(k, n) for any n > i; also fold_in(k, i).
__device__ __forceinline__ uint2 cw_key_at(uint2 k, uint32_t i) {
  return threefry2x32(k, make_uint2(0u, i));
}

// 32-bit random bits of the element at 64-bit linear index (hi, lo).
__device__ __forceinline__ uint32_t cw_bits_at(uint2 k, uint32_t hi, uint32_t lo) {
  const uint2 y = threefry2x32(k, make_uint2(hi, lo));
  return y.x ^ y.y;
}

// jax.random.uniform's float32 on [0, 1) from 32 bits.
__device__ __forceinline__ float cw_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// jax.random.randint's offset in [0, span) from its two 32-bit draws, in
// uint32 arithmetic that wraps as JAX's does.
__device__ __forceinline__ uint32_t cw_randint_offset(uint32_t higher, uint32_t lower,
                                                      uint32_t span) {
  const uint32_t m = 65536u % span;
  const uint32_t multiplier = (m * m) % span;
  return ((higher % span) * multiplier + lower % span) % span;
}

// jax.random.randint(k, shape, minval, minval + span)'s element at linear
// index (hi, lo): its bits from the two keys of split(k).
__device__ __forceinline__ int32_t cw_randint_at(uint2 k, uint32_t hi, uint32_t lo,
                                                 uint32_t span, int32_t minval) {
  const uint32_t higher = cw_bits_at(cw_key_at(k, 0u), hi, lo);
  const uint32_t lower = cw_bits_at(cw_key_at(k, 1u), hi, lo);
  return minval + (int32_t)cw_randint_offset(higher, lower, span);
}

// n % d for a runtime d, by a reciprocal computed on the host
// (ops/keyed_draws.fastmod_magic): the quotient is umulhi(magic, n) corrected
// by an add, exact for every 32-bit n (Granlund and Montgomery, "Division by
// invariant integers using multiplication", PLDI'94, fig. 4.1).
__device__ __forceinline__ uint32_t cw_fastmod(uint32_t n, uint32_t d, uint32_t magic, int s1,
                                               int s2) {
  const uint32_t t = __umulhi(magic, n);
  const uint32_t q = (t + ((n - t) >> s1)) >> s2;
  return n - q * d;
}

// jax.random.uniform(minval, maxval)'s float32 from 32 bits: f * span +
// minval in one fused multiply-add (XLA's CPU backend contracts it so; the
// explicit intrinsic leaves nvcc no choice), then max(minval, .).
__device__ __forceinline__ float cw_uniform_scaled(uint32_t bits, float fmin, float fspan) {
  return fmaxf(fmin, __fmaf_rn(cw_uniform(bits), fspan, fmin));
}

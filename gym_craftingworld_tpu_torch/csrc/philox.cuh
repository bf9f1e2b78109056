// Philox4x32-10, the counter-based generator of Salmon, Moraes, Dror and
// Shaw, "Parallel random numbers: as easy as 1, 2, 3" (SC'11).
//
// Bit for bit the generator of ops/philox.py, which reproduces every draw of
// these kernels in plain torch. The fused rollout kernels (packed_fused.cu)
// take their random actions from it: the action of env `b` at step `t` is
// word `t % 4` of philox4x32_10(counter (t / 4, b, 0, 0), key (seed,
// CW_ACTION_KEY)), reduced % 6. The stream therefore depends on (seed, b, t)
// alone, never on the launch shape.
#pragma once

#include <stdint.h>

#define CW_PHILOX_M0 0xD2511F53u
#define CW_PHILOX_M1 0xCD9E8D57u
#define CW_PHILOX_W0 0x9E3779B9u
#define CW_PHILOX_W1 0xBB67AE85u
// second key word of the action stream ("CWOR"); ops/packed_fused.py ACTION_KEY
#define CW_ACTION_KEY 0x43574F52u

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += CW_PHILOX_W0;
      k.y += CW_PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(CW_PHILOX_M0, c.x);
    const uint32_t lo0 = CW_PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(CW_PHILOX_M1, c.z);
    const uint32_t lo1 = CW_PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words that give env `env` its actions at steps 4*t4 .. 4*t4+3.
__device__ __forceinline__ uint4 action_words(uint32_t seed, uint32_t t4,
                                              uint32_t env) {
  return philox4x32_10(make_uint4(t4, env, 0u, 0u),
                       make_uint2(seed, CW_ACTION_KEY));
}

// The world pool for Hopper (sm_90a): n fresh worlds per launch, one warp per
// world.
//
// Replaces the Pallas kernel of gym_craftingworld_tpu/ops/fused_reset.py
// (_kernel, :71, behind fresh_packed_fused). Plain version and key layout:
// ops/fused_reset.py, which reproduces every key of this kernel bit for bit.
//
// What bounds it: integer issue. A world draws H*W + 16 Philox words (10
// rounds of two 32x32 multiplies each, ~115 Philox calls at 21x21) and runs
// 9 + n_sel rounds of an arg-max over them; it writes 10 ints. Nothing is read
// from device memory but the two seed words.
//
// Design: the TPU kernel laid cells on sublanes and envs on lanes so that
// each pick was a sublane reduction. Here a warp owns a world and each lane
// holds the keys of its Philox groups in registers (group g = lane + 32 i
// gives key words 4g .. 4g+3; 16 keys a lane at 21x21). A pick is a
// lane-local (max, lowest index) scan followed by a 5-step xor-shuffle
// butterfly on (key, index) pairs, which leaves every lane with the same
// pick; the lane that owns it masks it to -1. The 16 task keys come from
// lanes 0-3. The ragged edge of n is masked per warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

// second Philox key word of the pool stream ("CWPL"); ops/fused_reset.py POOL_KEY
#define CW_POOL_KEY 0x4357504Cu
#define CW_POOL_WARPS 8
#define CW_N_PICKS 9  // 8 objects + the agent
#define CW_NO_ROW 0x40000000

// (value, index) arg-max with ties to the lower index, over the warp.
__device__ __forceinline__ void warp_argmax(int32_t& best, int32_t& bidx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int32_t oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (ob > best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
    }
  }
}

// NI: Philox groups per lane, so 4 * 32 * NI >= H*W.
template <int NI>
__global__ void __launch_bounds__(32 * CW_POOL_WARPS)
    cw_pool_kernel(const int32_t* __restrict__ seeds, int32_t* __restrict__ picks,
                   int n, int hw, uint32_t sel_mask, int n_sel, int n_tasks,
                   int stacking) {
  const int lane = threadIdx.x & 31;
  const int world = blockIdx.x * CW_POOL_WARPS + (threadIdx.x >> 5);
  if (world >= n) return;  // the whole warp leaves together
  const uint2 key = make_uint2((uint32_t)seeds[0], CW_POOL_KEY);
  const uint32_t seed2 = (uint32_t)seeds[1];
  const int pg = (hw + 3) / 4;

  int32_t k[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int g = lane + 32 * i;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (g < pg) w = philox4x32_10(make_uint4((uint32_t)g, (uint32_t)world, seed2, 0u), key);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) k[i][q] = (4 * g + q < hw) ? (int32_t)(words[q] >> 1) : -1;
  }

  int32_t out[CW_N_PICKS + 1];
#pragma unroll
  for (int p = 0; p < CW_N_PICKS; ++p) {
    int32_t best = -1, bidx = CW_NO_ROW;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int32_t j = 4 * (lane + 32 * i) + q;
        if (k[i][q] > best || (k[i][q] == best && j < bidx)) {
          best = k[i][q];
          bidx = j;
        }
      }
    }
    warp_argmax(best, bidx);
    out[p] = bidx;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * (lane + 32 * i) + q == bidx) k[i][q] = -1;
    }
  }

  // task keys t = 4 * lane + q, lanes 0-3
  int32_t tk[4];
  {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (lane < 4)
      w = philox4x32_10(make_uint4((uint32_t)(pg + lane), (uint32_t)world, seed2, 0u), key);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) tk[q] = (int32_t)(words[q] >> 1);
  }
  const int32_t raw_k = __shfl_sync(0xffffffffu, tk[1], 2);  // task key 9
  const int kdraw = stacking ? raw_k % n_tasks + 1 : 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * lane + q;
    if (lane >= 4 || !((sel_mask >> t) & 1u)) tk[q] = -1;
  }
  int32_t desired = 0;
  for (int p = 0; p < n_sel; ++p) {
    int32_t best = -1, bidx = CW_NO_ROW;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int32_t t = 4 * lane + q;
      if (tk[q] > best || (tk[q] == best && t < bidx)) {
        best = tk[q];
        bidx = t;
      }
    }
    warp_argmax(best, bidx);
    if (p < kdraw) desired |= 1 << bidx;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * lane + q == bidx) tk[q] = -1;
  }
  out[CW_N_PICKS] = desired;

#pragma unroll
  for (int p = 0; p <= CW_N_PICKS; ++p)
    if (lane == p) picks[(size_t)p * n + world] = out[p];
}

// seeds: device int32[2]; picks: device int32[10, n] (8 slot cells, the
// agent's cell, the desired mask). Grids up to 1024 cells.
extern "C" int cw_pool(const void* seeds, void* picks, int n, int hw,
                       uint32_t sel_mask, int n_sel, int n_tasks, int stacking,
                       void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  const int pg = (hw + 3) / 4;
  const dim3 grid((n + CW_POOL_WARPS - 1) / CW_POOL_WARPS), block(32 * CW_POOL_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sd = (const int32_t*)seeds;
  int32_t* pk = (int32_t*)picks;
  if (pg <= 32)
    cw_pool_kernel<1><<<grid, block, 0, s>>>(sd, pk, n, hw, sel_mask, n_sel, n_tasks, stacking);
  else if (pg <= 64)
    cw_pool_kernel<2><<<grid, block, 0, s>>>(sd, pk, n, hw, sel_mask, n_sel, n_tasks, stacking);
  else if (pg <= 128)
    cw_pool_kernel<4><<<grid, block, 0, s>>>(sd, pk, n, hw, sel_mask, n_sel, n_tasks, stacking);
  else if (pg <= 256)
    cw_pool_kernel<8><<<grid, block, 0, s>>>(sd, pk, n, hw, sel_mask, n_sel, n_tasks, stacking);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

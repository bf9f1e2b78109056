// The env layer's jax.random draws for Hopper (sm_90a): a reset's per-env
// draws from each env's Threefry key, and one key's draws over a box of
// counters.
//
// Replaces no Pallas kernel: the JAX package draws these with jax.random
// under XLA (gym_craftingworld_tpu/core/reset.py:75,98,111,141,
// core/imagine.py:66,113, core/rollout.py:63). Plain version and layouts:
// ops/keyed_draws.py over ops/threefry.py, which reproduce every draw of
// these kernels, and of jax.random, bit for bit.
//
// What bounds them: integer issue. A Threefry call is ~80 32-bit integer
// operations (20 rounds of add, funnel-shift rotate and xor, 5 key
// injections); a reset makes 8 calls a cell (the world's score and 7 goal
// score rows) and ~20 an env, and writes 32 bytes a cell.
//
// cw_keyed_reset_kernel: one thread per (env, cell). A block holds 128
// cells of one env (blockIdx.x the env, blockIdx.y the chunk of cells); its
// first threads derive the env's subkeys in registers, 4 from
// split(key, 4) and 7 goal keys (split(k_goal, 6) and
// fold_in(goal key 5, 1)), and pass them through shared memory; then each
// thread hashes its cell under the world key and the 7 goal keys. The
// per-env task draws (randint k, a permutation of the selected tasks by
// rounds of a stable insertion sort, the pool pick) and k_next are written
// by the last thread of the env's first block, which holds fewer cells.
//
// cw_keyed_counter_kernel: one thread per element of a rows x width box of
// counters (row r, column c at index r * row_stride + col0 + c): the keys of
// a split (a rank's columns of split(key, B)) or randint over the box (a
// rank's columns of randint(key, (T, B))), randint's two keys derived once
// a block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define CW_KEYED_MAX_SEL 16
#define CW_GOAL_ROWS 7
#define CW_KEYED_CELLS 128
#define CW_COUNTER_THREADS 256

enum { CW_KEYED_FRESH = 0, CW_KEYED_POOL = 1, CW_KEYED_WORLD = 2 };
enum { CW_COUNTER_SPLIT = 0, CW_COUNTER_RANDINT = 1 };

__device__ __forceinline__ uint2 cw_load_key(const int64_t* keys, int64_t b) {
  return make_uint2((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1]);
}

__global__ void __launch_bounds__(CW_KEYED_CELLS)
    cw_keyed_reset_kernel(const int64_t* __restrict__ keys, int n, int mode, int n_sel,
                          uint32_t task_span, int stacking, uint32_t pool_span, int rounds,
                          int32_t* __restrict__ k_out, int32_t* __restrict__ perm_out,
                          float* __restrict__ world, int32_t* __restrict__ pick,
                          float* __restrict__ goal, int64_t* __restrict__ k_next) {
  __shared__ uint2 sub[4];  // k_task, k_world (or k_pick), k_goal, k_next
  __shared__ uint2 gk[CW_GOAL_ROWS];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const uint2 key = cw_load_key(keys, b);
  if (mode == CW_KEYED_WORLD) {
    if (t == 0) sub[1] = key;  // the key itself places the world
  } else if (t < 4) {
    sub[t] = cw_key_at(key, (uint32_t)t);
  }
  __syncthreads();
  if (mode != CW_KEYED_WORLD && t < CW_GOAL_ROWS) {
    const uint2 g = cw_key_at(sub[2], (uint32_t)(t < 6 ? t : 5));
    gk[t] = t < 6 ? g : cw_key_at(g, 1u);
  }
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + t;
  if (j < n) {
    if (mode != CW_KEYED_POOL)
      world[b * n + j] = cw_uniform(cw_bits_at(sub[1], 0u, (uint32_t)j));
    if (mode != CW_KEYED_WORLD) {
#pragma unroll
      for (int r = 0; r < CW_GOAL_ROWS; ++r)
        goal[(b * CW_GOAL_ROWS + r) * n + j] = cw_uniform(cw_bits_at(gk[r], 0u, (uint32_t)j));
    }
  }

  if (mode == CW_KEYED_WORLD || blockIdx.y != 0 || t != blockDim.x - 1) return;
  // the env's task draws: k_num, k_perm = split(k_task)
  const uint2 k_num = cw_key_at(sub[0], 0u);
  uint2 k_perm = cw_key_at(sub[0], 1u);
  k_out[b] = stacking ? 1 + cw_randint_at(k_num, 0u, 0u, task_span, 0) : 1;
  uint32_t s[CW_KEYED_MAX_SEL];
  int32_t v[CW_KEYED_MAX_SEL];
  for (int i = 0; i < n_sel; ++i) v[i] = i;
  for (int round = 0; round < rounds; ++round) {
    const uint2 sk = cw_key_at(k_perm, 1u);
    k_perm = cw_key_at(k_perm, 0u);
    for (int i = 0; i < n_sel; ++i) s[i] = cw_bits_at(sk, 0u, (uint32_t)i);
    for (int i = 1; i < n_sel; ++i) {  // stable: move only past strictly larger keys
      const uint32_t ks = s[i];
      const int32_t kv = v[i];
      int p = i - 1;
      while (p >= 0 && s[p] > ks) {
        s[p + 1] = s[p];
        v[p + 1] = v[p];
        --p;
      }
      s[p + 1] = ks;
      v[p + 1] = kv;
    }
  }
  for (int i = 0; i < n_sel; ++i) perm_out[b * n_sel + i] = v[i];
  if (mode == CW_KEYED_POOL) pick[b] = cw_randint_at(sub[1], 0u, 0u, pool_span, 0);
  k_next[2 * b] = sub[3].x;
  k_next[2 * b + 1] = sub[3].y;
}

__global__ void __launch_bounds__(CW_COUNTER_THREADS)
    cw_keyed_counter_kernel(const int64_t* __restrict__ key, int mode, int64_t rows,
                            int64_t row_stride, int64_t col0, int64_t width, uint32_t span,
                            int32_t minval, void* __restrict__ out) {
  __shared__ uint2 k[2];
  const uint2 key0 = cw_load_key(key, 0);
  if (mode == CW_COUNTER_RANDINT && threadIdx.x < 2) k[threadIdx.x] = cw_key_at(key0, threadIdx.x);
  __syncthreads();
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * width) return;
  const int64_t r = e / width;
  const uint64_t idx = (uint64_t)(r * row_stride + col0 + (e - r * width));
  const uint32_t hi = (uint32_t)(idx >> 32), lo = (uint32_t)idx;
  if (mode == CW_COUNTER_SPLIT) {
    const uint2 y = threefry2x32(key0, make_uint2(hi, lo));
    ((int64_t*)out)[2 * e] = y.x;
    ((int64_t*)out)[2 * e + 1] = y.y;
  } else {
    const uint32_t higher = cw_bits_at(k[0], hi, lo), lower = cw_bits_at(k[1], hi, lo);
    ((int32_t*)out)[e] = minval + (int32_t)cw_randint_offset(higher, lower, span);
  }
}

// keys: device int64[B, 2]; outputs (device, NULL where the mode writes
// none): k int32[B], perm int32[B, n_sel], world f32[B, n], pick int32[B],
// goal f32[B, 7, n], k_next int64[B, 2]. mode 0 fresh reset, 1 pool reset,
// 2 the world scores of each key alone (generate_pool).
extern "C" int cw_keyed_reset(const void* keys, int B, int n, int mode, int n_sel,
                              uint32_t task_span, int stacking, uint32_t pool_span, int rounds,
                              void* k_out, void* perm_out, void* world, void* pick, void* goal,
                              void* k_next, void* stream) {
  cudaGetLastError();
  if (B <= 0 || n <= 0) return 0;
  if (n_sel < 0 || n_sel > CW_KEYED_MAX_SEL || mode < 0 || mode > 2 || task_span == 0 ||
      pool_span == 0)
    return (int)cudaErrorInvalidValue;
  const int threads = n < CW_KEYED_CELLS ? ((n + 31) / 32) * 32 : CW_KEYED_CELLS;
  const dim3 grid(B, (n + threads - 1) / threads);
  cw_keyed_reset_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, n, mode, n_sel, task_span, stacking, pool_span, rounds,
      (int32_t*)k_out, (int32_t*)perm_out, (float*)world, (int32_t*)pick, (float*)goal,
      (int64_t*)k_next);
  return (int)cudaGetLastError();
}

// key: device int64[2]; out: device int64[rows * width, 2] (mode 0, split)
// or int32[rows * width] (mode 1, randint in [minval, minval + span)).
extern "C" int cw_keyed_counter(const void* key, int mode, long long rows, long long row_stride,
                                long long col0, long long width, uint32_t span, int32_t minval,
                                void* out, void* stream) {
  cudaGetLastError();
  const long long total = rows * width;
  if (total <= 0) return 0;
  if (mode < 0 || mode > 1 || span == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + CW_COUNTER_THREADS - 1) / CW_COUNTER_THREADS;
  cw_keyed_counter_kernel<<<(unsigned)blocks, CW_COUNTER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, mode, rows, row_stride, col0, width, span, minval, out);
  return (int)cudaGetLastError();
}

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
// The tasks mode makes those task draws alone, from each key itself, one
// warp an env.
//
// cw_keyed_counter_kernel (redesigned for this card): the draws of P key
// planes over a rows x width box of counters (plane p, row r, column c at
// index r * row_stride + col0 + c under plane p's key): the keys of a
// split, randint, the raw 32 bits (permutations' sort keys) or uniform
// floats on [minval, maxval). So one launch draws fast PPO's uniforms of
// T steps (plane t's key split(k_roll, T)[t], rows 6, a rank's columns) or
// a rank's columns of randint(key, (T, B)). What bounds it is integer
// issue, ~75 operations a Threefry call; the design spends as little else:
// a 2-D grid (blockIdx.y the plane and row, x the columns), 32-bit index
// arithmetic inside a row with the high counter word once a row, randint's
// modulo by a reciprocal computed on the host (three multiply-highs, no
// division), 4 consecutive columns a thread and one 16-byte store, the keys
// loaded once as 16-byte read-only loads and derived by each warp (the
// plane's split key, and randint's two subkeys in lanes 0 and 1 passed by
// __shfl_sync) with no block barrier. uniform's f * span + minval is one
// __fmaf_rn: the rounding JAX's CPU backend gives, which nvcc's default
// contraction would give too, but only by its choice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

#define CW_KEYED_MAX_SEL 16
#define CW_GOAL_ROWS 7
#define CW_KEYED_CELLS 128
#define CW_COUNTER_THREADS 256

enum { CW_KEYED_FRESH = 0, CW_KEYED_POOL = 1, CW_KEYED_WORLD = 2, CW_KEYED_TASKS = 3 };
enum { CW_COUNTER_SPLIT = 0, CW_COUNTER_RANDINT = 1, CW_COUNTER_BITS = 2, CW_COUNTER_UNIFORM = 3 };

// cw_keyed_counter's launch, by value (host-computed constants included).
struct CwCounterArgs {
  uint32_t plane_rows, rows, width;
  uint64_t row_stride, col0;
  int derive, vec;
  uint32_t span, multiplier, magic;
  int32_t minval;
  int s1, s2;
  float fmin, fspan;
};

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
  } else if (mode == CW_KEYED_TASKS) {
    if (t == 0) sub[0] = key;  // the key itself draws the tasks
  } else if (t < 4) {
    sub[t] = cw_key_at(key, (uint32_t)t);
  }
  __syncthreads();
  if (mode < CW_KEYED_WORLD && t < CW_GOAL_ROWS) {
    const uint2 g = cw_key_at(sub[2], (uint32_t)(t < 6 ? t : 5));
    gk[t] = t < 6 ? g : cw_key_at(g, 1u);
  }
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + t;
  if (j < n && mode != CW_KEYED_TASKS) {
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
  if (mode == CW_KEYED_TASKS) return;
  k_next[2 * b] = sub[3].x;
  k_next[2 * b + 1] = sub[3].y;
}

// One thread's 4 consecutive elements of one plane's row: counters (hi,
// lo + j) under the key k (and k2, randint's second key), written with
// one 16-byte store (four in split mode, one a key).
template <int MODE>
__device__ __forceinline__ void cw_counter_four(uint2 k, uint2 k2, uint32_t hi, uint32_t lo,
                                                const CwCounterArgs& a, void* out, int64_t e,
                                                int n) {
  if (MODE == CW_COUNTER_SPLIT) {
    longlong2* o = (longlong2*)out + e;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        const uint32_t l = lo + (uint32_t)j;
        const uint2 y = threefry2x32(k, make_uint2(hi + (l < lo), l));
        o[j] = make_longlong2((long long)y.x, (long long)y.y);
      }
    }
    return;
  }
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t l = lo + (uint32_t)j;
    const uint32_t h = hi + (l < lo);
    const uint32_t bits = cw_bits_at(k, h, l);
    if (MODE == CW_COUNTER_RANDINT) {
      const uint32_t lower = cw_bits_at(k2, h, l);
      const uint32_t x = cw_fastmod(bits, a.span, a.magic, a.s1, a.s2) * a.multiplier +
                         cw_fastmod(lower, a.span, a.magic, a.s1, a.s2);
      v[j] = (uint32_t)a.minval + cw_fastmod(x, a.span, a.magic, a.s1, a.s2);
    } else if (MODE == CW_COUNTER_UNIFORM) {
      v[j] = __float_as_uint(cw_uniform_scaled(bits, a.fmin, a.fspan));
    } else {
      v[j] = bits;
    }
  }
  uint32_t* o = (uint32_t*)out + e;
  if (n == 4 && a.vec) {
    *(uint4*)o = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) o[j] = v[j];
  }
}

// blockIdx.y walks (plane, row) pairs, blockIdx.x and the thread the row's
// columns, 4 a thread. Each warp makes its own keys: the plane's key
// (loaded, or split(parent, planes)[p]) and, for randint, split(plane key)'s
// two keys, one in each of lanes 0 and 1, passed to the warp by
// __shfl_sync; no barrier.
template <int MODE>
__global__ void __launch_bounds__(CW_COUNTER_THREADS)
    cw_keyed_counter_kernel(const longlong2* __restrict__ keys, CwCounterArgs a,
                            void* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t c = (blockIdx.x * CW_COUNTER_THREADS + threadIdx.x) * 4u;
  for (uint32_t pr = blockIdx.y; pr < a.plane_rows; pr += gridDim.y) {
    const uint32_t p = pr / a.rows, r = pr - p * a.rows;
    const longlong2 kd = __ldg(keys + (a.derive ? 0 : p));
    uint2 k = make_uint2((uint32_t)kd.x, (uint32_t)kd.y);
    if (a.derive) k = cw_key_at(k, p);
    uint2 k2 = k;
    if (MODE == CW_COUNTER_RANDINT) {
      const uint2 sk = cw_key_at(k, (uint32_t)(lane & 1));
      k = make_uint2(__shfl_sync(0xffffffffu, sk.x, 0), __shfl_sync(0xffffffffu, sk.y, 0));
      k2 = make_uint2(__shfl_sync(0xffffffffu, sk.x, 1), __shfl_sync(0xffffffffu, sk.y, 1));
    }
    if (c >= a.width) continue;
    // the row's first counter, 64-bit once a row; the row's columns in 32 bits
    const uint64_t base = (uint64_t)r * a.row_stride + a.col0;
    const uint32_t lo0 = (uint32_t)base + c;
    const uint32_t hi = (uint32_t)(base >> 32) + (lo0 < (uint32_t)base);
    const int n = min(4, (int)(a.width - c));
    cw_counter_four<MODE>(k, k2, hi, lo0, a, out, (int64_t)pr * a.width + c, n);
  }
}

// keys: device int64[B, 2]; outputs (device, NULL where the mode writes
// none): k int32[B], perm int32[B, n_sel], world f32[B, n], pick int32[B],
// goal f32[B, 7, n], k_next int64[B, 2]. mode 0 fresh reset, 1 pool reset,
// 2 the world scores of each key alone (generate_pool), 3 the tasks of each
// key alone (sample_desired's k and perm: fresh_packed_batch).
extern "C" int cw_keyed_reset(const void* keys, int B, int n, int mode, int n_sel,
                              uint32_t task_span, int stacking, uint32_t pool_span, int rounds,
                              void* k_out, void* perm_out, void* world, void* pick, void* goal,
                              void* k_next, void* stream) {
  cudaGetLastError();
  if (B <= 0 || n <= 0) return 0;
  if (n_sel < 0 || n_sel > CW_KEYED_MAX_SEL || mode < 0 || mode > 3 || task_span == 0 ||
      pool_span == 0)
    return (int)cudaErrorInvalidValue;
  // the tasks mode draws no cell: one warp an env, whose last lane draws
  const int cells = mode == CW_KEYED_TASKS ? 1 : n;
  const int threads = cells < CW_KEYED_CELLS ? ((cells + 31) / 32) * 32 : CW_KEYED_CELLS;
  const dim3 grid(B, (cells + threads - 1) / threads);
  cw_keyed_reset_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, n, mode, n_sel, task_span, stacking, pool_span, rounds,
      (int32_t*)k_out, (int32_t*)perm_out, (float*)world, (int32_t*)pick, (float*)goal,
      (int64_t*)k_next);
  return (int)cudaGetLastError();
}

// keys: device int64[planes, 2] (derive 0) or the parent int64[2] (derive
// 1: plane p's key is split(parent, planes)[p]), each 16-byte aligned. out:
// device [planes, rows, width] of int64 pairs (mode 0, split), int32
// (1, randint in [minval, minval + span)), uint32 bits (2) or float32 (3,
// uniform on [fmin, fmin + fspan)); element (p, r, c) is counter r *
// row_stride + col0 + c of plane p's key. magic, s1, s2: span's reciprocal
// (ops/keyed_draws.fastmod_magic); multiplier: randint's (2**16 % span)**2 %
// span, wrapped at 2**32.
extern "C" int cw_keyed_counter(const void* keys, int planes, int derive, int mode,
                                long long rows, long long row_stride, long long col0,
                                long long width, uint32_t span, int32_t minval,
                                uint32_t multiplier, uint32_t magic, int s1, int s2, float fmin,
                                float fspan, void* out, void* stream) {
  cudaGetLastError();
  if (planes <= 0 || rows <= 0 || width <= 0) return 0;
  const long long plane_rows = (long long)planes * rows;
  if (mode < 0 || mode > 3 || span == 0 || plane_rows > 0xFFFFFFFFll || width > 0x7FFFFFFFll ||
      ((uintptr_t)keys & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  CwCounterArgs a;
  a.plane_rows = (uint32_t)plane_rows;
  a.rows = (uint32_t)rows;
  a.row_stride = (uint64_t)row_stride;
  a.col0 = (uint64_t)col0;
  a.width = (uint32_t)width;
  a.derive = derive;
  a.vec = (width & 3) == 0;
  a.span = span;
  a.minval = minval;
  a.multiplier = multiplier;
  a.magic = magic;
  a.s1 = s1;
  a.s2 = s2;
  a.fmin = fmin;
  a.fspan = fspan;
  const long long per_block = 4ll * CW_COUNTER_THREADS;
  const dim3 grid((unsigned)((width + per_block - 1) / per_block),
                  (unsigned)(plane_rows < 65535 ? plane_rows : 65535));
  const cudaStream_t st = (cudaStream_t)stream;
  const longlong2* k = (const longlong2*)keys;
  switch (mode) {
    case CW_COUNTER_SPLIT:
      cw_keyed_counter_kernel<CW_COUNTER_SPLIT><<<grid, CW_COUNTER_THREADS, 0, st>>>(k, a, out);
      break;
    case CW_COUNTER_RANDINT:
      cw_keyed_counter_kernel<CW_COUNTER_RANDINT><<<grid, CW_COUNTER_THREADS, 0, st>>>(k, a, out);
      break;
    case CW_COUNTER_BITS:
      cw_keyed_counter_kernel<CW_COUNTER_BITS><<<grid, CW_COUNTER_THREADS, 0, st>>>(k, a, out);
      break;
    default:
      cw_keyed_counter_kernel<CW_COUNTER_UNIFORM><<<grid, CW_COUNTER_THREADS, 0, st>>>(k, a, out);
  }
  return (int)cudaGetLastError();
}

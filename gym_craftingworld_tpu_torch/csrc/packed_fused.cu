// Fused packed rollouts for Hopper (sm_90a): three kernels, one thread per
// env, each stepping the packed-key engine of packed_step.cuh.
//
// Replaces the Pallas kernels of gym_craftingworld_tpu/ops/packed_fused.py:
//   cw_bench_kernel   <- _bench_kernel (:101), behind fused_rollout_packed_bench
//   cw_actions_kernel <- _actions_kernel (:122), behind fused_rollout_packed
//   cw_stream_kernel  <- fused_action_stream's inner kernel (:247)
//
// What bounds them: integer issue and latency, not bytes. An env's state is
// 24 slot words and 9 scalars, read once and written once; a step is a chain
// of ~150 dependent integer compares and selects on registers. The bench
// kernel keeps the state in registers for all T steps and writes only the
// final state and one int32 checksum per env. Global memory keeps
// PackedState's int16 [8, B] / [B] layout, so neighbouring threads touch
// neighbouring addresses; registers are 32-bit.
//
// Occupancy: the headline batch of 16,384 envs is 16,384 threads, about 6%
// of the card's ~270k resident-thread slots (132 SMs x 2,048), so each SM
// sub-partition has about one warp to hide latency with. Filling the card
// (more envs per launch, or several envs per thread for ILP) is later work.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so that the caller can raise on a refused launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_step.cuh"
#include "philox.cuh"

#define CW_BLOCK 128

// PackedState field order (ops/packed_rollout.py): slot_key, slot_type,
// init_key, init_type, agent_r, agent_c, holding, obj_here, icode_here,
// achieved, desired, init_agent_key, step_num. Outputs are the 9 mutable
// fields in that order: slot_key, slot_type, agent_r, agent_c, holding,
// obj_here, icode_here, achieved, step_num.
#define CW_N_IN 13
#define CW_N_OUT 9

struct PackedIO {
  const int16_t* in[CW_N_IN];
  int16_t* out[CW_N_OUT];
};

__device__ __forceinline__ void load_env(const PackedIO& io, int b, int B,
                                         PackedEnv& s) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s.key[i] = io.in[0][i * B + b];
    s.typ[i] = io.in[1][i * B + b];
    s.ikey[i] = io.in[2][i * B + b];
  }
  s.agent_r = io.in[4][b];
  s.agent_c = io.in[5][b];
  s.holding = io.in[6][b];
  s.obj_here = io.in[7][b];
  s.icode_here = io.in[8][b];
  s.achieved = io.in[9][b];
  s.desired = io.in[10][b];
  s.init_agent_key = io.in[11][b];
  s.step_num = io.in[12][b];
}

__device__ __forceinline__ void store_env(const PackedIO& io, int b, int B,
                                          const PackedEnv& s) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    io.out[0][i * B + b] = (int16_t)s.key[i];
    io.out[1][i * B + b] = (int16_t)s.typ[i];
  }
  io.out[2][b] = (int16_t)s.agent_r;
  io.out[3][b] = (int16_t)s.agent_c;
  io.out[4][b] = (int16_t)s.holding;
  io.out[5][b] = (int16_t)s.obj_here;
  io.out[6][b] = (int16_t)s.icode_here;
  io.out[7][b] = (int16_t)s.achieved;
  io.out[8][b] = (int16_t)s.step_num;
}

// T steps with actions from the Philox stream; final state + reward sum.
__global__ void __launch_bounds__(CW_BLOCK)
    cw_bench_kernel(PackedIO io, int32_t* __restrict__ checksum, int B, int T,
                    CwCfg cfg, uint32_t seed) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  PackedEnv s;
  load_env(io, b, B, s);
  int acc = 0;
  bool done;
  for (int t0 = 0; t0 < T; t0 += 4) {
    const uint4 w = action_words(seed, (uint32_t)(t0 >> 2), (uint32_t)b);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + j < T) acc += packed_step(s, (int)(words[j] % CW_N_ACTIONS), cfg, done);
    }
  }
  store_env(io, b, B, s);
  checksum[b] = acc;
}

// T steps over a given int32 [T, B] action slab; rewards and dones per step.
__global__ void __launch_bounds__(CW_BLOCK)
    cw_actions_kernel(PackedIO io, const int32_t* __restrict__ actions,
                      int32_t* __restrict__ reward, uint8_t* __restrict__ done,
                      int B, int T, CwCfg cfg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  PackedEnv s;
  load_env(io, b, B, s);
  for (int t = 0; t < T; ++t) {
    const size_t at = (size_t)t * B + b;
    bool d;
    reward[at] = packed_step(s, actions[at], cfg, d);
    done[at] = d;
  }
  store_env(io, b, B, s);
}

// The bench kernel's action stream alone, as int32 [T, B].
__global__ void __launch_bounds__(CW_BLOCK)
    cw_stream_kernel(int32_t* __restrict__ out, int B, int T, uint32_t seed) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int t0 = 0; t0 < T; t0 += 4) {
    const uint4 w = action_words(seed, (uint32_t)(t0 >> 2), (uint32_t)b);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + j < T) out[(size_t)(t0 + j) * B + b] = (int32_t)(words[j] % CW_N_ACTIONS);
    }
  }
}

static PackedIO make_io(const void* const* in, void* const* out) {
  PackedIO io;
  for (int i = 0; i < CW_N_IN; ++i) io.in[i] = (const int16_t*)in[i];
  for (int i = 0; i < CW_N_OUT; ++i) io.out[i] = (int16_t*)out[i];
  return io;
}

static int grid_for(int B) { return (B + CW_BLOCK - 1) / CW_BLOCK; }

// `in` and `out` are host arrays of CW_N_IN and CW_N_OUT device pointers.
extern "C" int cw_packed_bench(const void* const* in, void* const* out,
                               void* checksum, int B, int T, int height,
                               int width, int max_steps, int reward_equal,
                               uint32_t seed, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const CwCfg cfg = {height, width, max_steps, reward_equal};
  if (B > 0)
    cw_bench_kernel<<<grid_for(B), CW_BLOCK, 0, (cudaStream_t)stream>>>(
        make_io(in, out), (int32_t*)checksum, B, T, cfg, seed);
  return (int)cudaGetLastError();
}

extern "C" int cw_packed_actions(const void* const* in, void* const* out,
                                 const void* actions, void* reward, void* done,
                                 int B, int T, int height, int width,
                                 int max_steps, int reward_equal,
                                 void* stream) {
  cudaGetLastError();
  const CwCfg cfg = {height, width, max_steps, reward_equal};
  if (B > 0)
    cw_actions_kernel<<<grid_for(B), CW_BLOCK, 0, (cudaStream_t)stream>>>(
        make_io(in, out), (const int32_t*)actions, (int32_t*)reward,
        (uint8_t*)done, B, T, cfg);
  return (int)cudaGetLastError();
}

extern "C" int cw_action_stream(void* out, int B, int T, uint32_t seed,
                                void* stream) {
  cudaGetLastError();
  if (B > 0)
    cw_stream_kernel<<<grid_for(B), CW_BLOCK, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, B, T, seed);
  return (int)cudaGetLastError();
}

extern "C" const char* cw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

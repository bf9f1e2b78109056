// Fused packed rollouts for Hopper (sm_90a): three kernels, one thread per
// env, each stepping the packed-key engine of packed_step.cuh.
//
// Replaces the Pallas kernels of gym_craftingworld_tpu/ops/packed_fused.py:
//   cw_bench_kernel   <- _bench_kernel (:101), behind fused_rollout_packed_bench
//   cw_actions_kernel <- _actions_kernel (:122), behind fused_rollout_packed
//   cw_stream_kernel  <- fused_action_stream's inner kernel (:247)
//
// What bounds them: integer issue, not bytes. An env's state is 24 slot
// words and 9 scalars, read once and written once; the bench kernel keeps it
// in registers for all T steps and writes only the final state and one int32
// checksum per env. Global memory keeps PackedState's int16 [8, B] / [B]
// layout, so neighbouring threads touch neighbouring addresses.
//
// Occupancy and issue: 16,384 envs are 128 blocks of 128 threads, one warp on
// each of 512 of the card's 528 schedulers (132 SMs x 4). A lone warp issues
// in order, so at that size the step's dependent instructions leave issue
// slots idle; at 131,072 envs (eight warps a scheduler) the integer pipe,
// which takes a warp-instruction every second clock, is the limit
// (chip_smoke.py phases 1 and 6 count both). What the kernels do about it:
//   * packed_step.cuh keeps the slot compares wide and branch-free and moves
//     the reset-cell sum to the FMA pipe (its header has the design);
//   * the bench kernel computes the next trip's four Philox draws beside the
//     current trip's steps: they are independent of the state, and fill the
//     issue slots the steps leave idle;
//   * the actions kernel keeps its next CW_AHEAD actions in a ring of
//     registers, loaded CW_AHEAD steps early, so no step waits on its own
//     action's load, with one copy of the step in the loop (an unrolled
//     trip of four made the one-step launch of the collect slower).
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so that the caller can raise on a refused launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_step.cuh"
#include "philox.cuh"

#define CW_BLOCK 128
// how many steps ahead the actions kernel loads its actions
#define CW_AHEAD 4

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

// T steps with actions from the Philox stream; final state + reward sum.
// Thread b draws the stream of env env0 + b, so that a shard of a batch (its
// first env at env0) steps the same envs as the whole batch does.
__global__ void __launch_bounds__(CW_BLOCK)
    cw_bench_kernel(PackedIO io, int32_t* __restrict__ checksum, int B, int T,
                    CwCfg cfg, uint32_t seed, uint32_t env0) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t env = env0 + (uint32_t)b;
  PackedEnv s;
  packed_load(io.in, b, B, cfg, s);
  int acc = 0;
  bool done;
  // the next trip's draws are computed beside this trip's steps, which
  // leave most issue slots of a lone warp idle while they wait on each other
  uint4 w = action_words(seed, 0u, env);
  for (int t0 = 0; t0 < T; t0 += 4) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    w = action_words(seed, (uint32_t)(t0 >> 2) + 1u, env);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + j < T) acc += packed_step(s, (int)(words[j] % CW_N_ACTIONS), cfg, done);
    }
  }
  packed_store(io.out, b, B, s);
  checksum[b] = acc;
}

// T steps over a given int32 [T, B] action slab; rewards and dones per step.
// Each thread keeps its next CW_AHEAD actions in a ring of registers and loads
// each action CW_AHEAD steps before it is stepped, so no step waits on its own
// action's load; the step itself stays one copy in the loop.
__global__ void __launch_bounds__(CW_BLOCK)
    cw_actions_kernel(PackedIO io, const int32_t* __restrict__ actions,
                      int32_t* __restrict__ reward, uint8_t* __restrict__ done,
                      int B, int T, CwCfg cfg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  PackedEnv s;
  packed_load(io.in, b, B, cfg, s);
  int ring[CW_AHEAD];
#pragma unroll
  for (int j = 0; j < CW_AHEAD; ++j)
    ring[j] = j < T ? __ldg(actions + (size_t)j * B + b) : 0;
  for (int t = 0; t < T; ++t) {
    const int action = ring[0];
#pragma unroll
    for (int j = 0; j + 1 < CW_AHEAD; ++j) ring[j] = ring[j + 1];
    const int ahead = t + CW_AHEAD;
    ring[CW_AHEAD - 1] = ahead < T ? __ldg(actions + (size_t)ahead * B + b) : 0;
    const size_t at = (size_t)t * B + b;
    bool d;
    reward[at] = packed_step(s, action, cfg, d);
    done[at] = d;
  }
  packed_store(io.out, b, B, s);
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

// `in` and `out` are host arrays of CW_N_IN and CW_N_OUT device pointers;
// env0 is the batch index of the first env (0 unless the batch is a shard).
extern "C" int cw_packed_bench(const void* const* in, void* const* out,
                               void* checksum, int B, int T, int height,
                               int width, int max_steps, int reward_equal,
                               uint32_t seed, uint32_t env0, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const CwCfg cfg = {height, width, max_steps, reward_equal};
  if (B > 0)
    cw_bench_kernel<<<grid_for(B), CW_BLOCK, 0, (cudaStream_t)stream>>>(
        make_io(in, out), (int32_t*)checksum, B, T, cfg, seed, env0);
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

// Fused slot-layout rollouts for Hopper (sm_90a): one thread per env, the
// whole T-step rollout on registers, in both slot layouts of slot_step.cuh.
//
// Replaces the Pallas kernels
//   gym_craftingworld_tpu/ops/fused_rollout.py:227 `_rollout_kernel`
//     (fused_rollout, [B, 8] layout, random actions)       -> cw_fused_rollout, actions == NULL
//   gym_craftingworld_tpu/ops/fused_rollout.py:242 `_actions_rollout_kernel`
//     (fused_rollout_actions, [B, 8] layout, given actions) -> cw_fused_rollout
//   gym_craftingworld_tpu/ops/fused_rollout_t.py:165 `_kernel`
//     (fused_rollout_t, [8, B] layout, random actions)     -> cw_fused_rollout_t
//
// What bounds them: integer instruction throughput and latency, as for the
// packed kernels (packed_fused.cu). An env's state is ~60 words, read once and written
// once; a step is a chain of a few hundred dependent integer compares and
// selects on registers, and each step writes one int32 reward and one byte
// of done per env into [T, B] slabs, where neighbouring threads write
// neighbouring addresses. The design keeps everything else out of memory:
// the state lives in registers for all T steps, the task vectors as 9-bit
// masks. In the [B, 8] layout an env's slot fields are contiguous, so a
// thread reads and writes them as 16-byte vectors; in the [8, B] layout every
// field access is coalesced across the warp.
//
// Not carried over from the TPU kernels: the env blocks and the B % block
// rule (any B works; the last block masks its ragged edge), the [B, 1]
// columns and keepdims reductions of Mosaic, the VMEM limit, and the TPU's
// per-block generator seeded with seed + block. Random actions come from the
// Philox stream of the packed bench kernel (philox.cuh): the action of env b
// at step t depends on (seed, b, t) alone, so cw_fused_rollout,
// cw_fused_rollout_t and the packed bench kernel step the same actions from
// the same seed.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so that the caller can raise on a refused launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "slot_step.cuh"

#define CW_SLOT_BLOCK 128

// T steps of env b; actions from `actions` [T, B], or from the Philox stream
// of `seed` when kSeeded. Rewards and dones per step into [T, B].
template <class Layout, bool kSeeded>
__global__ void __launch_bounds__(CW_SLOT_BLOCK)
    cw_slot_rollout_kernel(Layout io, const int32_t* __restrict__ actions,
                           int32_t* __restrict__ reward,
                           uint8_t* __restrict__ done, int B, int T, CwCfg cfg,
                           uint32_t seed) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  SlotEnv s;
  io.load(b, B, s);
  bool d;
  if (kSeeded) {
    for (int t0 = 0; t0 < T; t0 += 4) {
      const uint4 w = action_words(seed, (uint32_t)(t0 >> 2), (uint32_t)b);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t0 + j < T) {
          const size_t at = (size_t)(t0 + j) * B + b;
          reward[at] = slot_step(s, (int)(words[j] % CW_N_ACTIONS), cfg, d);
          done[at] = d;
        }
      }
    }
  } else {
    for (int t = 0; t < T; ++t) {
      const size_t at = (size_t)t * B + b;
      reward[at] = slot_step(s, actions[at], cfg, d);
      done[at] = d;
    }
  }
  io.store(b, B, s);
}

static RowsLayout make_rows(const void* const* in, void* const* out) {
  RowsLayout io;
  io.slot_type = (const int32_t*)in[0];
  io.slot_pos = (const int32_t*)in[1];
  io.slot_stat = (const int32_t*)in[2];
  io.agent = (const int32_t*)in[3];
  io.desired = (const int8_t*)in[4];
  io.achieved = (const int8_t*)in[5];
  io.init_type = (const int32_t*)in[6];
  io.init_pos = (const int32_t*)in[7];
  io.init_agent = (const int32_t*)in[8];
  io.step_num = (const int32_t*)in[9];
  io.o_slot_type = (int32_t*)out[0];
  io.o_slot_pos = (int32_t*)out[1];
  io.o_slot_stat = (int32_t*)out[2];
  io.o_agent = (int32_t*)out[3];
  io.o_achieved = (int8_t*)out[4];
  io.o_step_num = (int32_t*)out[5];
  return io;
}

static ColumnsLayout make_columns(const void* const* in, void* const* out) {
  ColumnsLayout io;
  const int32_t** fin[ColumnsLayout::N_IN] = {
      &io.slot_type, &io.slot_pos_r, &io.slot_pos_c, &io.slot_stat,
      &io.agent_r, &io.agent_c, &io.desired, &io.achieved, &io.init_type,
      &io.init_pos_r, &io.init_pos_c, &io.init_agent_r, &io.init_agent_c,
      &io.step_num};
  int32_t** fout[ColumnsLayout::N_OUT] = {
      &io.o_slot_type, &io.o_slot_pos_r, &io.o_slot_pos_c, &io.o_slot_stat,
      &io.o_agent_r, &io.o_agent_c, &io.o_achieved, &io.o_step_num};
  for (int i = 0; i < ColumnsLayout::N_IN; ++i) *fin[i] = (const int32_t*)in[i];
  for (int i = 0; i < ColumnsLayout::N_OUT; ++i) *fout[i] = (int32_t*)out[i];
  return io;
}

static int slot_grid_for(int B) { return (B + CW_SLOT_BLOCK - 1) / CW_SLOT_BLOCK; }

// [B, 8] layout. `in` and `out` are host arrays of RowsLayout::N_IN and
// N_OUT device pointers; `actions` is int32 [T, B], or NULL for the Philox
// stream of `seed`.
extern "C" int cw_fused_rollout(const void* const* in, void* const* out,
                                const void* actions, void* reward, void* done,
                                int B, int T, int height, int width,
                                int max_steps, int reward_equal, uint32_t seed,
                                void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const CwCfg cfg = {height, width, max_steps, reward_equal};
  const RowsLayout io = make_rows(in, out);
  const cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && actions)
    cw_slot_rollout_kernel<RowsLayout, false><<<slot_grid_for(B), CW_SLOT_BLOCK, 0, st>>>(
        io, (const int32_t*)actions, (int32_t*)reward, (uint8_t*)done, B, T, cfg, seed);
  else if (B > 0)
    cw_slot_rollout_kernel<RowsLayout, true><<<slot_grid_for(B), CW_SLOT_BLOCK, 0, st>>>(
        io, nullptr, (int32_t*)reward, (uint8_t*)done, B, T, cfg, seed);
  return (int)cudaGetLastError();
}

// [8, B] layout, Philox actions. `in` and `out` are host arrays of
// ColumnsLayout::N_IN and N_OUT device pointers.
extern "C" int cw_fused_rollout_t(const void* const* in, void* const* out,
                                  void* reward, void* done, int B, int T,
                                  int height, int width, int max_steps,
                                  int reward_equal, uint32_t seed, void* stream) {
  cudaGetLastError();
  const CwCfg cfg = {height, width, max_steps, reward_equal};
  if (B > 0)
    cw_slot_rollout_kernel<ColumnsLayout, true>
        <<<slot_grid_for(B), CW_SLOT_BLOCK, 0, (cudaStream_t)stream>>>(
            make_columns(in, out), nullptr, (int32_t*)reward, (uint8_t*)done, B,
            T, cfg, seed);
  return (int)cudaGetLastError();
}

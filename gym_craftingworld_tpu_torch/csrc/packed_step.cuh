// One step of the packed-key CraftingWorld engine, for one env held in
// registers.
//
// The algebra is `_step_p_unrolled` of ops/packed_rollout.py (and of the JAX
// package's gym_craftingworld_tpu/ops/packed_rollout.py:360), with the batch
// axis taken away: each thread owns one env. See ops/packed_rollout.py for the
// key encoding: key = r * W + c on the grid, H * W while held, H * W + 1 once
// removed. Slot k starts as object code k + 1, and only some slots can change:
// only slots 0, 4 and 7 change type (sticks->house, tree->sticks->house,
// wheat->bread); only slots 3, 5 and 7 can be removed; only slots 0, 1, 2 and
// 4 are picked up or dropped. The masks below name those classes; the step
// resolves them at compile time.
//
// What bounds it on Hopper (chip_smoke.py phase 1 counts the SASS by pipe):
// the integer pipe where warps are many, issue latency where they are few.
// An SM sub-partition has 16 INT32 lanes, so a warp-instruction on that pipe
// (compares, selects, bit logic) holds it two clocks, while IMAD, IMAD.HI and
// adds of an immediate (VIADD) go to the FMA pipe beside it. At the headline
// 16,384 envs each scheduler holds one warp, which issues in order, so the
// step's time is set by how much independent work sits between dependent
// instructions as much as by their count.
//
// What the design does about it:
//   * the slot-key compares stay eight independent ISETP/SEL pairs: wide and
//     shallow, they keep a lone warp issuing (packing the keys as 16-bit
//     pairs too, the `swar_pairs` variant of PERF.md, cut the integer
//     instructions but chained them, and ran 29% slower at 16,384 envs);
//   * the reset-cell codes, off the step's critical path, are a SWAR (SIMD
//     within a register) masked sum: init keys are below 2^15, so two share a
//     word, each half with bit 15 set ("flagged"). For a broadcast key
//     K = k * 0x10001, (w - K) & (K + 0x10000 - w) & 0x80008000 keeps bit 15
//     of a half exactly where that half equals k (per half 0x8000 + key - k
//     and 0x8000 + k - key never borrow across halves and both keep bit 15
//     only when key == k), and for that mask e = a * 2^15 + b * 2^31 and
//     q = c_lo * 2^17 + c_hi * 2 the low 16 bits of umulhi(e, q) are
//     a * c_lo + b * c_hi: four FMA-pipe subtraction pairs, four LOP3s and
//     four IMAD.HIs in place of 24 integer-pipe instructions;
//   * no branch: the boolean algebra uses & and | and the selects are masks,
//     since a branch on the data diverges in nearly every warp;
//   * the tasks' start mark and the success test are carried per env
//     (`marked_here`, `success_mask`) instead of recomputed every step.
//
// Domain: keys and type codes as `pack` makes them, keys in [0, 2^15) and
// codes in [0, 16); the results equal the plain step's bit for bit there.
#pragma once

#include <stdint.h>

// Object, holding, task and action codes: constants.py, pinned by
// tests/test_torch_scaffold.py.
#define CW_EMPTY 0
#define CW_STICKS 1
#define CW_AXE 2
#define CW_HAMMER 3
#define CW_ROCK 4
#define CW_TREE 5
#define CW_BREAD 6
#define CW_HOUSE 7
#define CW_WHEAT 8
#define CW_AGENT_INIT_MARK 9
#define CW_HOLD_NONE 0
#define CW_HOLD_STICKS 1
#define CW_HOLD_AXE 2
#define CW_HOLD_HAMMER 3
#define CW_T_MAKE_BREAD 0
#define CW_T_EAT_BREAD 1
#define CW_T_BUILD_HOUSE 2
#define CW_T_CHOP_TREE 3
#define CW_T_CHOP_ROCK 4
#define CW_T_GO_TO_HOUSE 5
#define CW_T_MOVE_AXE 6
#define CW_T_MOVE_HAMMER 7
#define CW_T_MOVE_STICKS 8
#define CW_ACTION_UP 0
#define CW_ACTION_RIGHT 1
#define CW_ACTION_DOWN 2
#define CW_ACTION_LEFT 3
#define CW_ACTION_PICKUP 4
#define CW_ACTION_DROP 5
#define CW_N_ACTIONS 6

#define CW_DYNTYPE_SLOTS 0x91u    // slots 0, 4, 7
#define CW_REMOVABLE_SLOTS 0xA8u  // slots 3, 5, 7
#define CW_PICKUP_SLOTS 0x17u     // slots 0, 1, 2, 4

// bit 15 of both halves of a pair word
#define CW_FLAGS 0x80008000u

// The static part of EnvConfig that the step reads.
struct CwCfg {
  int height;
  int width;
  int max_steps;
  int reward_equal;
};

// The code word of a pair: the masked sum's multiplier for codes lo, hi.
__host__ __device__ constexpr uint32_t cw_code_word(uint32_t lo, uint32_t hi) {
  return (lo << 17) | (hi << 1);
}

// One env's PackedState in registers: one 32-bit register a slot key, the
// init keys as flagged pairs (slot 2j low, 2j + 1 high), the types of slots
// 0, 4 and 7 (the other slots' codes are constants), every scalar widened.
struct PackedEnv {
  int key[8];       // slot_key
  uint32_t ikw[4];  // init_key pairs, flagged (constant)
  int typ0, typ4, typ7;
  uint32_t fixed_typ[3];  // slot types that never change, slots 1, 2 | 3, 5 | 6, as pairs
  int agent_r, agent_c, cur_key, holding, obj_here, icode_here;
  int marked_here;  // icode_here, or the agent's start mark on its start cell
  int achieved, desired, success_mask, init_agent_key, step_num;
};

// Bit 15 of each half of `w` set where that half equals the key broadcast in
// `kb` (k * 0x10001); `kb1` is kb + 0x10000.
__device__ __forceinline__ uint32_t cw_eq_pairs(uint32_t w, uint32_t kb, uint32_t kb1) {
  return (w - kb) & (kb1 - w) & CW_FLAGS;
}

// hi(a * b) + c: the masked code sum's step, one IMAD.HI.
__device__ __forceinline__ uint32_t cw_madhi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// An init-key pair word, flagged.
__device__ __forceinline__ uint32_t cw_pair(int lo, int hi) {
  return ((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16) | CW_FLAGS;
}

// Steps `s` by `action` in place; returns the reward and sets `done`.
__device__ __forceinline__ int packed_step(PackedEnv& s, int action,
                                           const CwCfg& cfg, bool& done) {
  const int W = cfg.width;
  const int held_key = cfg.height * cfg.width;
  const int r = s.agent_r, c = s.agent_c, cur_key = s.cur_key;
  const int obj_here = s.obj_here, holding = s.holding;

  // dr + 1 and dc + 1 of actions 0-3, two bits each, four bits an action. A
  // step off the grid leaves the agent where it is, and then nothing reads
  // new_key; actions outside 0-3 never step (a negative one still counts as
  // a move for the tasks, as in the plain step).
  const uint32_t f = 0x1694u >> ((action & 3) << 2);
  const int new_r = r + (int)(f & 3u) - 1;
  const int new_c = c + (int)((f >> 2) & 3u) - 1;
  const bool is_move = action < CW_ACTION_PICKUP;
  const bool steps = ((unsigned)action < (unsigned)CW_ACTION_PICKUP) &
                     ((unsigned)new_r < (unsigned)cfg.height) & ((unsigned)new_c < (unsigned)W);
  const int new_key = new_r * W + new_c;

  // codes at the destination cell: the slot codes, eight independent
  // compares (fixed-type slots contribute their constant code), and the
  // reset-cell codes, a masked sum over the four init-key pairs
  bool at_there[8];
  int obj_there = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    at_there[i] = s.key[i] == new_key;
    const int code = i == 0 ? s.typ0 : i == 4 ? s.typ4 : i == 7 ? s.typ7 : i + 1;
    obj_there += at_there[i] ? code : 0;
  }
  const uint32_t kb = (uint32_t)new_key * 0x10001u, kb1 = kb + 0x10000u;
  const int icode_there =
      cw_madhi(cw_eq_pairs(s.ikw[0], kb, kb1), cw_code_word(1, 2),
               cw_madhi(cw_eq_pairs(s.ikw[1], kb, kb1), cw_code_word(3, 4),
                        cw_madhi(cw_eq_pairs(s.ikw[2], kb, kb1), cw_code_word(5, 6),
                                 __umulhi(cw_eq_pairs(s.ikw[3], kb, kb1),
                                          cw_code_word(7, 8))))) & 0xFFFF;

  // the step's boolean algebra is written with & and |: a short-circuit
  // && or || may compile to a branch, which diverges in nearly every warp
  const bool blocked =
      ((obj_there == CW_ROCK) & (holding != CW_HOLD_HAMMER)) |
      ((obj_there == CW_TREE) & (holding != CW_HOLD_AXE));
  const bool move_ok = steps & !blocked;

  const bool can_pickup = (action == CW_ACTION_PICKUP) &
                          ((unsigned)(obj_here - CW_STICKS) <= (unsigned)(CW_HAMMER - CW_STICKS)) &
                          (holding == CW_HOLD_NONE);
  const bool can_drop = (action == CW_ACTION_DROP) &
                        (holding != CW_HOLD_NONE) & (obj_here == CW_EMPTY);

  // crafting effects on the scalar code (craftingworld_ray.py:416-438)
  const bool make_bread = (obj_there == CW_WHEAT) & (holding == CW_HOLD_AXE);
  const bool build_house = (obj_there == CW_STICKS) & (holding == CW_HOLD_HAMMER);
  const int eff = obj_there == CW_TREE ? CW_STICKS
                  : build_house        ? CW_HOUSE
                  : make_bread         ? CW_BREAD
                                       : obj_there;
  const bool removed = (obj_there == CW_ROCK) | (obj_there == CW_BREAD);

  // slot updates, restricted to each slot's possible transitions; every
  // predicate reads the keys as they were before this step
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = s.key[i];
    int nk = k;
    if ((CW_REMOVABLE_SLOTS >> i) & 1u) {
      if (at_there[i] & move_ok & removed) nk = held_key + 1;
    }
    if ((CW_PICKUP_SLOTS >> i) & 1u) {
      if (can_pickup & (k == cur_key)) nk = held_key;
      if (can_drop & (k == held_key)) nk = cur_key;
    }
    s.key[i] = nk;
  }
  if (at_there[0] & move_ok) s.typ0 = eff;
  if (at_there[4] & move_ok) s.typ4 = eff;
  if (at_there[7] & move_ok) s.typ7 = eff;

  if (move_ok) {
    s.agent_r = new_r;
    s.agent_c = new_c;
    s.cur_key = new_key;
  }
  s.holding = can_pickup ? obj_here : (can_drop ? CW_HOLD_NONE : holding);

  // task evaluation as bit algebra (craftingworld_ray.py:646-703)
  const int a = s.achieved;
  const int latched =
      a | (((int(make_bread) << CW_T_MAKE_BREAD) |
            (int(obj_there == CW_BREAD) << CW_T_EAT_BREAD) |
            (int(build_house) << CW_T_BUILD_HOUSE) |
            (int(obj_there == CW_TREE) << CW_T_CHOP_TREE) |
            (int(obj_there == CW_ROCK) << CW_T_CHOP_ROCK)) & -int(move_ok));

  // GoToHouse: recomputed from the cell the agent ends the move on
  const int cell_final = move_ok ? (removed ? CW_EMPTY : eff) : obj_here;

  // Move{Axe,Hammer,Sticks}: the held item's task bit `mb` is cleared, then
  // set when the agent's cell is not the item's reset cell (the reset-cell
  // code, or the start mark on the agent's start cell); sticks also count a
  // tree's cell once a tree was chopped
  const int marked_there =
      ((icode_there == 0) & (new_key == s.init_agent_key)) ? CW_AGENT_INIT_MARK : icode_there;
  const int marked = move_ok ? marked_there : s.marked_here;
  const int mb = holding == CW_HOLD_STICKS  ? 1 << CW_T_MOVE_STICKS
                 : holding == CW_HOLD_AXE    ? 1 << CW_T_MOVE_AXE
                 : holding == CW_HOLD_HAMMER ? 1 << CW_T_MOVE_HAMMER
                                             : 0;
  const bool away = (marked != holding) &
                    !((holding == CW_HOLD_STICKS) & (marked == CW_TREE) &
                      ((latched >> CW_T_CHOP_TREE) & 1));
  const int moved_tasks = (latched & ~((1 << CW_T_GO_TO_HOUSE) | mb)) |
                          (int(cell_final == CW_HOUSE) << CW_T_GO_TO_HOUSE) | (away ? mb : 0);
  const int achieved = a ^ ((moved_tasks ^ a) & -int(is_move));  // is_move ? moved_tasks : a
  s.achieved = achieved;

  // carried here-codes: the agent's new cell is the move destination, or
  // the same cell with the object removed (pickup) / re-placed (drop)
  s.obj_here = move_ok ? cell_final
                       : (can_pickup ? CW_EMPTY : (can_drop ? holding : obj_here));
  if (move_ok) {
    s.icode_here = icode_there;
    s.marked_here = marked_there;
  }

  // success: achieved == desired, or desired within achieved
  // (success_mask is all ones, or desired)
  const bool changed = move_ok | can_pickup | can_drop;
  const bool success = ((achieved ^ s.desired) & s.success_mask) == 0;
  const int reward = (changed & success) ? cfg.max_steps : -1;
  // saturates at max_steps, so a rollout of any length stays in int16
  s.step_num = min(s.step_num + 1, cfg.max_steps);
  done = (s.step_num >= cfg.max_steps) | (reward == cfg.max_steps);
  return reward;
}

// One env's packed state from PackedState's int16 [8, B] / [B] layout
// (fields in PackedState order: slot_key, slot_type, init_key, init_type,
// agent_r, agent_c, holding, obj_here, icode_here, achieved, desired,
// init_agent_key, step_num).
__device__ __forceinline__ void packed_load(const int16_t* const* in, int b, int B,
                                            const CwCfg& cfg, PackedEnv& s) {
  const int16_t* key = in[0];
  const int16_t* typ = in[1];
  const int16_t* ikey = in[2];
#pragma unroll
  for (int i = 0; i < 8; ++i) s.key[i] = key[i * B + b];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s.ikw[j] = cw_pair(ikey[(2 * j) * B + b], ikey[(2 * j + 1) * B + b]);
  s.fixed_typ[0] = ((uint32_t)typ[1 * B + b] & 0xFFFFu) | ((uint32_t)typ[2 * B + b] << 16);
  s.fixed_typ[1] = ((uint32_t)typ[3 * B + b] & 0xFFFFu) | ((uint32_t)typ[5 * B + b] << 16);
  s.fixed_typ[2] = (uint32_t)typ[6 * B + b] & 0xFFFFu;
  s.typ0 = typ[0 * B + b];
  s.typ4 = typ[4 * B + b];
  s.typ7 = typ[7 * B + b];
  s.agent_r = in[4][b];
  s.agent_c = in[5][b];
  s.cur_key = s.agent_r * cfg.width + s.agent_c;
  s.holding = in[6][b];
  s.obj_here = in[7][b];
  s.icode_here = in[8][b];
  s.achieved = in[9][b];
  s.desired = in[10][b];
  s.success_mask = cfg.reward_equal ? -1 : s.desired;
  s.init_agent_key = in[11][b];
  s.marked_here = (s.icode_here == 0 && s.cur_key == s.init_agent_key)
                      ? CW_AGENT_INIT_MARK : s.icode_here;
  s.step_num = in[12][b];
}

// The 9 mutable fields back to the int16 layout: slot_key, slot_type,
// agent_r, agent_c, holding, obj_here, icode_here, achieved, step_num.
__device__ __forceinline__ void packed_store(int16_t* const* out, int b, int B,
                                             const PackedEnv& s) {
  const int typ[8] = {s.typ0, (int)s.fixed_typ[0], (int)(s.fixed_typ[0] >> 16),
                      (int)s.fixed_typ[1], s.typ4, (int)(s.fixed_typ[1] >> 16),
                      (int)s.fixed_typ[2], s.typ7};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[0][i * B + b] = (int16_t)s.key[i];
    out[1][i * B + b] = (int16_t)typ[i];
  }
  out[2][b] = (int16_t)s.agent_r;
  out[3][b] = (int16_t)s.agent_c;
  out[4][b] = (int16_t)s.holding;
  out[5][b] = (int16_t)s.obj_here;
  out[6][b] = (int16_t)s.icode_here;
  out[7][b] = (int16_t)s.achieved;
  out[8][b] = (int16_t)s.step_num;
}

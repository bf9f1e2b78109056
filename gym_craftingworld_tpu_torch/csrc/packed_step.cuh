// One step of the packed-key CraftingWorld engine, for one env held in
// registers.
//
// The algebra is `_step_p_unrolled` of ops/packed_rollout.py (and of the JAX
// package's gym_craftingworld_tpu/ops/packed_rollout.py:360), with the batch
// axis taken away: each thread owns one env and carries its whole packed
// state in 32-bit registers. See ops/packed_rollout.py for the key encoding:
//   key = r * W + c on the grid, H * W while held, H * W + 1 once removed.
// Slot k starts as object code k + 1, and only some slots can change:
//   only slots 0, 4 and 7 change type (sticks->house, tree->sticks->house,
//   wheat->bread); only slots 3, 5 and 7 can be removed; only slots 0, 1, 2
//   and 4 are picked up or dropped. The masks below encode those classes; a
//   fully unrolled loop resolves them at compile time.
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

// The static part of EnvConfig that the step reads.
struct CwCfg {
  int height;
  int width;
  int max_steps;
  int reward_equal;
};

// One env's PackedState, every field widened to 32 bits.
struct PackedEnv {
  int key[8];   // slot_key
  int typ[8];   // slot_type
  int ikey[8];  // init_key (init_type is k + 1 for slot k, never read)
  int agent_r, agent_c, holding, obj_here, icode_here;
  int achieved, desired, init_agent_key, step_num;
};

// Steps `s` by `action` in place; returns the reward and sets `done`.
__device__ __forceinline__ int packed_step(PackedEnv& s, int action,
                                           const CwCfg& cfg, bool& done) {
  const int W = cfg.width;
  const int held_key = cfg.height * cfg.width;

  const int dr = (action == CW_ACTION_DOWN) - (action == CW_ACTION_UP);
  const int dc = (action == CW_ACTION_RIGHT) - (action == CW_ACTION_LEFT);
  const bool is_move = action < CW_ACTION_PICKUP;

  const int new_r = min(max(s.agent_r + dr, 0), cfg.height - 1);
  const int new_c = min(max(s.agent_c + dc, 0), cfg.width - 1);
  const int cur_key = s.agent_r * W + s.agent_c;
  const int new_key = new_r * W + new_c;
  const bool moved_pos = new_key != cur_key;

  // codes at the destination cell: at most one slot matches
  int obj_there = 0, icode_there = 0;
  bool at_there[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    at_there[i] = s.key[i] == new_key;
    const int code = ((CW_DYNTYPE_SLOTS >> i) & 1u) ? s.typ[i] : i + 1;
    obj_there += at_there[i] ? code : 0;
    icode_there += (s.ikey[i] == new_key) ? i + 1 : 0;
  }

  const int obj_here = s.obj_here;
  const int holding = s.holding;
  const bool blocked =
      (obj_there == CW_ROCK && holding != CW_HOLD_HAMMER) ||
      (obj_there == CW_TREE && holding != CW_HOLD_AXE);
  const bool move_ok = is_move && moved_pos && !blocked;

  const bool can_pickup = action == CW_ACTION_PICKUP && obj_here >= CW_STICKS &&
                          obj_here <= CW_HAMMER && holding == CW_HOLD_NONE;
  const bool can_drop = action == CW_ACTION_DROP &&
                        holding != CW_HOLD_NONE && obj_here == CW_EMPTY;

  // crafting effects on the scalar code (craftingworld_ray.py:416-438)
  int eff = obj_there;
  if (obj_there == CW_TREE) eff = CW_STICKS;
  if (obj_there == CW_STICKS && holding == CW_HOLD_HAMMER) eff = CW_HOUSE;
  if (obj_there == CW_WHEAT && holding == CW_HOLD_AXE) eff = CW_BREAD;
  const bool removed = obj_there == CW_ROCK || obj_there == CW_BREAD;

  // slot updates, restricted to each slot's possible transitions; every
  // predicate reads the keys as they were before this step
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = s.key[i];
    int nk = k;
    if ((CW_DYNTYPE_SLOTS >> i) & 1u) {
      if (at_there[i] && move_ok) s.typ[i] = eff;
    }
    if ((CW_REMOVABLE_SLOTS >> i) & 1u) {
      if (at_there[i] && move_ok && removed) nk = held_key + 1;
    }
    if ((CW_PICKUP_SLOTS >> i) & 1u) {
      if (can_pickup && k == cur_key) nk = held_key;
      if (can_drop && k == held_key) nk = cur_key;
    }
    s.key[i] = nk;
  }

  if (move_ok) {
    s.agent_r = new_r;
    s.agent_c = new_c;
  }
  s.holding = can_pickup ? obj_here : (can_drop ? CW_HOLD_NONE : holding);

  // task evaluation as bit algebra (craftingworld_ray.py:646-703)
  const int a = s.achieved;
  const bool eat = move_ok && obj_there == CW_BREAD;
  const bool chop_rock = move_ok && obj_there == CW_ROCK;
  const bool chop_tree = move_ok && obj_there == CW_TREE;
  const bool make_bread =
      move_ok && obj_there == CW_WHEAT && holding == CW_HOLD_AXE;
  const bool build_house =
      move_ok && obj_there == CW_STICKS && holding == CW_HOLD_HAMMER;
  const int latched = a | (int(make_bread) << CW_T_MAKE_BREAD) |
                      (int(eat) << CW_T_EAT_BREAD) |
                      (int(build_house) << CW_T_BUILD_HOUSE) |
                      (int(chop_tree) << CW_T_CHOP_TREE) |
                      (int(chop_rock) << CW_T_CHOP_ROCK);

  // GoToHouse: recomputed from the cell the agent ends the move on
  const int cell_final = move_ok ? (removed ? 0 : eff) : obj_here;
  const bool house = cell_final == CW_HOUSE;

  // Move{Axe,Hammer,Sticks}: carried item away from its reset cell
  const int icode = move_ok ? icode_there : s.icode_here;
  const int final_key = move_ok ? new_key : cur_key;
  const int marked = (icode == 0 && final_key == s.init_agent_key)
                         ? CW_AGENT_INIT_MARK
                         : icode;
  const bool a_ctree = (latched >> CW_T_CHOP_TREE) & 1;
  const bool init_empty = marked == CW_EMPTY;
  const bool ms =
      init_empty || !(marked == CW_STICKS || (marked == CW_TREE && a_ctree));
  const bool ma = init_empty || marked != CW_AXE;
  const bool mh = init_empty || marked != CW_HAMMER;

  const bool hold_sticks = holding == CW_HOLD_STICKS;
  const bool hold_axe = holding == CW_HOLD_AXE;
  const bool hold_hammer = holding == CW_HOLD_HAMMER;
  const int clear = (1 << CW_T_GO_TO_HOUSE) | (int(hold_axe) << CW_T_MOVE_AXE) |
                    (int(hold_hammer) << CW_T_MOVE_HAMMER) |
                    (int(hold_sticks) << CW_T_MOVE_STICKS);
  const int setb = (int(house) << CW_T_GO_TO_HOUSE) |
                   (int(hold_axe && ma) << CW_T_MOVE_AXE) |
                   (int(hold_hammer && mh) << CW_T_MOVE_HAMMER) |
                   (int(hold_sticks && ms) << CW_T_MOVE_STICKS);
  const int achieved = is_move ? ((latched & ~clear) | setb) : a;
  s.achieved = achieved;

  // carried here-codes: the agent's new cell is the move destination, or
  // the same cell with the object removed (pickup) / re-placed (drop)
  s.obj_here = move_ok ? cell_final
                       : (can_pickup ? 0 : (can_drop ? holding : obj_here));
  if (move_ok) s.icode_here = icode_there;

  const bool changed = move_ok || can_pickup || can_drop;
  const bool success = cfg.reward_equal ? achieved == s.desired
                                        : (s.desired & ~achieved) == 0;
  const int reward = (changed && success) ? cfg.max_steps : -1;
  // saturates at max_steps, so a rollout of any length stays in int16
  s.step_num = min(s.step_num + 1, cfg.max_steps);
  done = s.step_num >= cfg.max_steps || reward == cfg.max_steps;
  return reward;
}

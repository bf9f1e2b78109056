// One step of the entity-slot CraftingWorld engine, for one env held in
// registers, and the loads and stores of that env in the two slot layouts.
//
// The algebra is `_step_fields` of core/slots.py (the JAX package's
// core/slots.py:145 `_step_slots_one`, ops/fused_rollout.py:60 `_step_block`
// and ops/fused_rollout_t.py:34 `_step_tk`), with the batch axis taken away.
// Unlike the packed engine (packed_step.cuh) it makes no assumption about
// which slot holds which object: every slot is tested against the agent's
// cell and the move target, and the slot sums (holding, the two cell codes,
// the reset code of the final cell) are taken as the plain version takes
// them, so any state gives the plain version's bits.
//
// The 9 task bits are 9-bit masks in registers: bit k is task k.
#pragma once

#include <stdint.h>

#include "packed_step.cuh"  // object, holding, task and action codes; CwCfg

// slot status codes: core/slots.py ON_GRID, HELD, REMOVED
#define CW_ON_GRID 0
#define CW_HELD 1
#define CW_REMOVED 2

// One env's SlotState, every field 32 bits.
struct SlotEnv {
  int typ[8], row[8], col[8], stat[8];  // slot_type, slot_pos, slot_stat
  int ityp[8], irow[8], icol[8];        // init_type, init_pos
  int agent_r, agent_c, init_agent_r, init_agent_c, step_num;
  int desired, achieved;  // 9-bit task masks
};

// Steps `s` by `action` in place; returns the reward and sets `done`.
__device__ __forceinline__ int slot_step(SlotEnv& s, int action,
                                         const CwCfg& cfg, bool& done) {
  const int dr = (action == CW_ACTION_DOWN) - (action == CW_ACTION_UP);
  const int dc = (action == CW_ACTION_RIGHT) - (action == CW_ACTION_LEFT);
  const bool is_move = action < CW_ACTION_PICKUP;
  const int new_r = min(max(s.agent_r + dr, 0), cfg.height - 1);
  const int new_c = min(max(s.agent_c + dc, 0), cfg.width - 1);
  const bool moved_pos = new_r != s.agent_r || new_c != s.agent_c;

  // slot sums over the state before the step
  int holding = 0, obj_here = 0, obj_there = 0;
  unsigned here = 0, there = 0, held = 0;  // per-slot bits
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool on = s.stat[i] == CW_ON_GRID;
    const bool h = s.stat[i] == CW_HELD;
    const bool at_here = on && s.row[i] == s.agent_r && s.col[i] == s.agent_c;
    const bool at_there = on && s.row[i] == new_r && s.col[i] == new_c;
    holding += h ? s.typ[i] : 0;
    obj_here += at_here ? s.typ[i] : 0;
    obj_there += at_there ? s.typ[i] : 0;
    here |= unsigned(at_here) << i;
    there |= unsigned(at_there) << i;
    held |= unsigned(h) << i;
  }

  const bool blocked =
      (obj_there == CW_ROCK && holding != CW_HOLD_HAMMER) ||
      (obj_there == CW_TREE && holding != CW_HOLD_AXE);
  const bool move_ok = is_move && moved_pos && !blocked;
  const bool can_pickup = action == CW_ACTION_PICKUP && obj_here >= CW_STICKS &&
                          obj_here <= CW_HAMMER && holding == CW_HOLD_NONE;
  const bool can_drop = action == CW_ACTION_DROP &&
                        holding != CW_HOLD_NONE && obj_here == CW_EMPTY;

  // crafting effects on the slots under the move target, then pickup / drop
  // (craftingworld_ray.py:314-341, 416-438)
  int eff_there = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = s.typ[i];
    int eff = t;
    if (t == CW_TREE) eff = CW_STICKS;
    if (t == CW_STICKS && holding == CW_HOLD_HAMMER) eff = CW_HOUSE;
    if (t == CW_WHEAT && holding == CW_HOLD_AXE) eff = CW_BREAD;
    const bool removed = t == CW_ROCK || t == CW_BREAD;
    const bool hit = ((there >> i) & 1u) && move_ok;
    eff_there += (hit && !removed) ? eff : 0;
    if (hit) s.typ[i] = eff;
    int st = s.stat[i];
    if (hit && removed) st = CW_REMOVED;
    if (can_pickup && ((here >> i) & 1u)) st = CW_HELD;
    if (can_drop && ((held >> i) & 1u)) {
      st = CW_ON_GRID;
      s.row[i] = s.agent_r;
      s.col[i] = s.agent_c;
    }
    s.stat[i] = st;
  }
  if (move_ok) {
    s.agent_r = new_r;
    s.agent_c = new_c;
  }

  // reset-time code of the agent's final cell: an init slot, else the
  // agent-start mark, else empty
  int icode = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    icode += (s.irow[i] == s.agent_r && s.icol[i] == s.agent_c) ? s.ityp[i] : 0;
  if (icode == 0 && s.init_agent_r == s.agent_r && s.init_agent_c == s.agent_c)
    icode = CW_AGENT_INIT_MARK;

  // task evaluation as bit algebra (craftingworld_ray.py:646-703); move
  // actions only
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
  const int cell_final = move_ok ? eff_there : obj_here;
  const bool house = cell_final == CW_HOUSE;
  const bool a_ctree = (latched >> CW_T_CHOP_TREE) & 1;
  const bool init_empty = icode == CW_EMPTY;
  const bool ms =
      init_empty || !(icode == CW_STICKS || (icode == CW_TREE && a_ctree));
  const bool ma = init_empty || icode != CW_AXE;
  const bool mh = init_empty || icode != CW_HAMMER;
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

  const bool changed = move_ok || can_pickup || can_drop;
  const bool success = cfg.reward_equal ? achieved == s.desired
                                        : (s.desired & ~achieved) == 0;
  const int reward = (changed && success) ? cfg.max_steps : -1;
  s.step_num = min(s.step_num + 1, cfg.max_steps);
  done = s.step_num >= cfg.max_steps || reward == cfg.max_steps;
  return reward;
}

// ---------------------------------------------------------------------------
// The two layouts. Each holds the device pointers of one state in and one
// state out and loads or stores env `b` of `B`.
// ---------------------------------------------------------------------------

// SlotState as the port keeps it (core/slots.py), slot axis last: slot_type,
// slot_stat, init_type int32 [B, 8]; slot_pos, init_pos int32 [B, 8, 2];
// agent, init_agent int32 [B, 2]; desired, achieved int8 [B, 9]; step_num
// int32 [B]. An env's 8 slots are 32 contiguous bytes (64 for positions),
// read and written as 16-byte vectors.
struct RowsLayout {
  enum { N_IN = 10, N_OUT = 6 };
  // in: slot_type, slot_pos, slot_stat, agent, desired, achieved, init_type,
  // init_pos, init_agent, step_num
  const int32_t *slot_type, *slot_pos, *slot_stat, *agent;
  const int8_t *desired, *achieved;
  const int32_t *init_type, *init_pos, *init_agent, *step_num;
  // out: slot_type, slot_pos, slot_stat, agent, achieved, step_num
  int32_t *o_slot_type, *o_slot_pos, *o_slot_stat, *o_agent;
  int8_t* o_achieved;
  int32_t* o_step_num;

  __device__ __forceinline__ static void load8(const int32_t* p, int b, int* v) {
    const int4* q = reinterpret_cast<const int4*>(p + (size_t)b * 8);
    const int4 x = q[0], y = q[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
  __device__ __forceinline__ static void load_pos(const int32_t* p, int b,
                                                  int* r, int* c) {
    const int4* q = reinterpret_cast<const int4*>(p + (size_t)b * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 x = q[j];
      r[2 * j] = x.x; c[2 * j] = x.y; r[2 * j + 1] = x.z; c[2 * j + 1] = x.w;
    }
  }
  __device__ __forceinline__ static int load_mask(const int8_t* p, int b) {
    int m = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) m |= int(p[(size_t)b * 9 + k] != 0) << k;
    return m;
  }
  __device__ __forceinline__ static void store8(int32_t* p, int b, const int* v) {
    int4* q = reinterpret_cast<int4*>(p + (size_t)b * 8);
    q[0] = make_int4(v[0], v[1], v[2], v[3]);
    q[1] = make_int4(v[4], v[5], v[6], v[7]);
  }

  __device__ __forceinline__ void load(int b, int B, SlotEnv& s) const {
    load8(slot_type, b, s.typ);
    load8(slot_stat, b, s.stat);
    load8(init_type, b, s.ityp);
    load_pos(slot_pos, b, s.row, s.col);
    load_pos(init_pos, b, s.irow, s.icol);
    const int2 a = reinterpret_cast<const int2*>(agent)[b];
    const int2 ia = reinterpret_cast<const int2*>(init_agent)[b];
    s.agent_r = a.x; s.agent_c = a.y;
    s.init_agent_r = ia.x; s.init_agent_c = ia.y;
    s.desired = load_mask(desired, b);
    s.achieved = load_mask(achieved, b);
    s.step_num = step_num[b];
  }

  __device__ __forceinline__ void store(int b, int B, const SlotEnv& s) const {
    store8(o_slot_type, b, s.typ);
    store8(o_slot_stat, b, s.stat);
    int4* q = reinterpret_cast<int4*>(o_slot_pos + (size_t)b * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = make_int4(s.row[2 * j], s.col[2 * j], s.row[2 * j + 1], s.col[2 * j + 1]);
    reinterpret_cast<int2*>(o_agent)[b] = make_int2(s.agent_r, s.agent_c);
#pragma unroll
    for (int k = 0; k < 9; ++k) o_achieved[(size_t)b * 9 + k] = (s.achieved >> k) & 1;
    o_step_num[b] = s.step_num;
  }
};

// TSlotState (ops/transposed_rollout.py), slot axis first: every slot field
// int32 [8, B], desired and achieved int32 [9, B], the rest int32 [B].
// Neighbouring threads touch neighbouring addresses in every field.
struct ColumnsLayout {
  enum { N_IN = 14, N_OUT = 8 };
  // in: slot_type, slot_pos_r, slot_pos_c, slot_stat, agent_r, agent_c,
  // desired, achieved, init_type, init_pos_r, init_pos_c, init_agent_r,
  // init_agent_c, step_num
  const int32_t *slot_type, *slot_pos_r, *slot_pos_c, *slot_stat, *agent_r,
      *agent_c, *desired, *achieved, *init_type, *init_pos_r, *init_pos_c,
      *init_agent_r, *init_agent_c, *step_num;
  // out: slot_type, slot_pos_r, slot_pos_c, slot_stat, agent_r, agent_c,
  // achieved, step_num
  int32_t *o_slot_type, *o_slot_pos_r, *o_slot_pos_c, *o_slot_stat,
      *o_agent_r, *o_agent_c, *o_achieved, *o_step_num;

  __device__ __forceinline__ void load(int b, int B, SlotEnv& s) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t at = (size_t)i * B + b;
      s.typ[i] = slot_type[at];
      s.row[i] = slot_pos_r[at];
      s.col[i] = slot_pos_c[at];
      s.stat[i] = slot_stat[at];
      s.ityp[i] = init_type[at];
      s.irow[i] = init_pos_r[at];
      s.icol[i] = init_pos_c[at];
    }
    s.desired = 0;
    s.achieved = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      s.desired |= int(desired[(size_t)k * B + b] != 0) << k;
      s.achieved |= int(achieved[(size_t)k * B + b] != 0) << k;
    }
    s.agent_r = agent_r[b];
    s.agent_c = agent_c[b];
    s.init_agent_r = init_agent_r[b];
    s.init_agent_c = init_agent_c[b];
    s.step_num = step_num[b];
  }

  __device__ __forceinline__ void store(int b, int B, const SlotEnv& s) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t at = (size_t)i * B + b;
      o_slot_type[at] = s.typ[i];
      o_slot_pos_r[at] = s.row[i];
      o_slot_pos_c[at] = s.col[i];
      o_slot_stat[at] = s.stat[i];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) o_achieved[(size_t)k * B + b] = (s.achieved >> k) & 1;
    o_agent_r[b] = s.agent_r;
    o_agent_c[b] = s.agent_c;
    o_step_num[b] = s.step_num;
  }
};

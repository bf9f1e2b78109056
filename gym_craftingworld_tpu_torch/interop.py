"""Carry states between the JAX package and this one, through numpy.

The JAX package's states arrive as dicts of numpy arrays keyed by field name
(``{k: np.asarray(v) ...}`` of an ``EnvState``, ``SlotState``,
``TSlotState`` or ``PackedState``), and leave the same way. Every field keeps its dtype except
``rng``: the JAX package's uint32 key data becomes the port's int64 key
data (the same words, ``ops/threefry.py``), from which the port's auto-reset
continues as JAX's does, and goes back to uint32 on the way out.

Weights cross the same way: the fast-PPO policy's ``MLPParams`` and the
pixel policy's ``ConvParams`` as dicts of f32 numpy arrays under the JAX
names and layouts (``w1 b1 w2 b2 wl bl wv bv``; ``k1 b1 k2 b2 w1 bd wl bl wv
bv``, kernels HWIO), and their Adam state as optax's ``ScaleByAdamState``
fields: a dict ``{"count": int32 scalar, "mu": {...}, "nu": {...}}`` with
one such dict of arrays per moment, keyed like the parameters.

The flax families (``ActorCritic``, ``PixelActorCritic``,
``PixelDistillStudent``, ``GridActorCritic``, ``GridPolicy``,
``CPVPolicy``, ``CPVGridPolicy``, ``RecurrentActorCritic``) cross as their
flax variable trees, ``{"params": {module: {param: array}}}`` nested as flax
nests them. The port's modules hold their parameters under the same names and
in the same layouts, so a tree loads by name; the widths are read from the
tree. The trainers' states (``BCTrainState``, ``RnnTrainState``, and
``train/ppo.TrainState`` of the three PPO families) cross with
optax's ``chain(clip_by_global_norm, adam)`` state: an empty clip state, then
``ScaleByAdamState`` with its moments over the flax tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.actor_critic import ActorCritic
from gym_craftingworld_tpu_torch.models.cnn import PixelActorCritic, PixelDistillStudent
from gym_craftingworld_tpu_torch.models.cpv import CPVGridPolicy, CPVPolicy
from gym_craftingworld_tpu_torch.models.grid_policy import N_EXTRAS, GridPolicy
from gym_craftingworld_tpu_torch.models.rnn import RecurrentActorCritic
from gym_craftingworld_tpu_torch.models.vit import GridActorCritic
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.ops.transposed_rollout import TSlotState
from gym_craftingworld_tpu_torch.train.fast_pixel_ppo import CONV_NAMES, ConvParams
from gym_craftingworld_tpu_torch.train.dagger import BCTrainState
from gym_craftingworld_tpu_torch.train.fast_ppo import PARAM_NAMES, AdamState, MLPParams
from gym_craftingworld_tpu_torch.train.ppo import TrainState
from gym_craftingworld_tpu_torch.train.ppo_rnn import RnnTrainState


def _tensors(names, d: dict, device) -> dict:
    out = {}
    for k in names:
        a = np.array(d[k], dtype=np.int64 if k == "rng" else None)  # a copy
        out[k] = torch.from_numpy(a).to(device)
    return out


def _arrays(items) -> dict:
    out = {}
    for k, v in items:
        a = v.detach().cpu().numpy()
        out[k] = a.astype(np.uint32) if k == "rng" else a
    return out


def env_state_from_numpy(d: dict, device="cuda") -> EnvState:
    names = [f.name for f in dataclasses.fields(EnvState)]
    return EnvState(**_tensors(names, d, device))


def slot_state_from_numpy(d: dict, device="cuda") -> SlotState:
    return SlotState(**_tensors(SlotState._fields, d, device))


def tslot_state_from_numpy(d: dict, device="cuda") -> TSlotState:
    return TSlotState(**_tensors(TSlotState._fields, d, device))


def packed_state_from_numpy(d: dict, device="cuda") -> PackedState:
    return PackedState(**_tensors(PackedState._fields, d, device))


def env_state_to_numpy(state: EnvState) -> dict:
    return _arrays((f.name, getattr(state, f.name))
                   for f in dataclasses.fields(EnvState))


def slot_state_to_numpy(state: SlotState) -> dict:
    return _arrays(state._asdict().items())


def tslot_state_to_numpy(state: TSlotState) -> dict:
    return _arrays(state._asdict().items())


def packed_state_to_numpy(state: PackedState) -> dict:
    return _arrays(state._asdict().items())


def mlp_params_from_numpy(d: dict, device="cuda") -> MLPParams:
    """The JAX ``MLPParams`` (a dict of numpy arrays) as the port's module."""
    H, F = np.shape(d["w1"])
    params = MLPParams(F, H, device=device)
    with torch.no_grad():
        for k in PARAM_NAMES:
            getattr(params, k).copy_(torch.from_numpy(np.array(d[k], dtype=np.float32)))
    return params


def mlp_params_to_numpy(params: MLPParams) -> dict:
    return {k: getattr(params, k).detach().cpu().numpy() for k in PARAM_NAMES}


def conv_params_from_numpy(d: dict, device="cuda") -> ConvParams:
    """The JAX ``ConvParams`` (a dict of numpy arrays) as the port's module."""
    _, _, c1, c2 = np.shape(d["k2"])
    rows, hidden = np.shape(d["w1"])
    params = ConvParams(c1, c2, rows - 22, hidden, device=device)
    with torch.no_grad():
        for k in CONV_NAMES:
            getattr(params, k).copy_(torch.from_numpy(np.array(d[k], dtype=np.float32)))
    return params


def conv_params_to_numpy(params: ConvParams) -> dict:
    return {k: getattr(params, k).detach().cpu().numpy() for k in CONV_NAMES}


def adam_state_from_numpy(d: dict, device="cuda") -> AdamState:
    """optax ``ScaleByAdamState`` fields (numpy) as the port's ``AdamState``,
    with the moments' parameter names as they come (``MLPParams``' or
    ``ConvParams``')."""
    moment = lambda m: {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                        for k, v in m.items()}
    count = torch.tensor(int(np.asarray(d["count"])), dtype=torch.int32, device=device)
    return AdamState(count, moment(d["mu"]), moment(d["nu"]))


def adam_state_to_numpy(state: AdamState) -> dict:
    moment = lambda m: {k: v.detach().cpu().numpy() for k, v in m.items()}
    return {"count": np.int32(int(state.count)), "mu": moment(state.mu),
            "nu": moment(state.nu)}


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as {"a.b.c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _load_flax(model: torch.nn.Module, variables: dict, device) -> torch.nn.Module:
    """``model`` (built on the meta device) holding the arrays of flax
    ``variables``, by name and in their shapes."""
    flat = _flat_tree(variables["params"])
    model = model.to_empty(device="cpu")
    names = dict(model.named_parameters())
    if sorted(flat) != sorted(names):
        raise ValueError(f"flax tree {sorted(flat)} does not match the module's "
                         f"parameters {sorted(names)}")
    with torch.no_grad():
        for k, p in names.items():
            p.data = torch.from_numpy(np.array(flat[k], dtype=np.float32))
    return model.to(device)


def actor_critic_from_numpy(variables: dict, device="cuda") -> ActorCritic:
    """A flax ``ActorCritic``'s variables as the port's module."""
    d_in, hidden = np.shape(variables["params"]["torso0"]["kernel"])
    return _load_flax(ActorCritic(d_in, hidden, device="meta"), variables, device)


def pixel_actor_critic_from_numpy(variables: dict, device="cuda") -> PixelActorCritic:
    """A flax ``PixelActorCritic``'s variables as the port's module."""
    hidden = np.shape(variables["params"]["Dense_0"]["kernel"])[1]
    return _load_flax(PixelActorCritic(hidden=hidden, device="meta"), variables, device)


def pixel_distill_student_from_numpy(variables: dict, device="cuda") -> PixelDistillStudent:
    """A flax ``PixelDistillStudent``'s variables as the port's module."""
    p = variables["params"]
    model = PixelDistillStudent(channels=np.shape(p["conv0"]["kernel"])[3],
                                hidden=np.shape(p["dense0"]["kernel"])[1],
                                stem=np.shape(p["stem"]["kernel"])[3], device="meta")
    return _load_flax(model, variables, device)


def grid_actor_critic_from_numpy(variables: dict, device="cuda") -> GridActorCritic:
    """A flax ``GridActorCritic``'s variables as the port's module."""
    p = variables["params"]
    _, n_tokens, hidden = np.shape(p["pos"])
    depth = sum(k.startswith("block") for k in p)
    heads = np.shape(p["block0"]["MultiHeadDotProductAttention_0"]["query"]["kernel"])[1]
    model = GridActorCritic(n_tokens, hidden, depth, heads, device="meta")
    return _load_flax(model, variables, device)


def grid_policy_from_numpy(variables: dict, device="cuda") -> GridPolicy:
    """A flax ``GridPolicy``'s variables as the port's module. The tree
    fixes the grid's cell count H*W (``dense0`` has ``H*W*32 + 33`` rows),
    which is all the module's shapes depend on."""
    p = variables["params"]
    hw = (np.shape(p["dense0"]["kernel"])[0] - N_EXTRAS) // 32
    model = GridPolicy(1, hw, channels=np.shape(p["conv0"]["kernel"])[3],
                       hidden=np.shape(p["dense0"]["kernel"])[1], device="meta")
    return _load_flax(model, variables, device)


def cpv_grid_policy_from_numpy(variables: dict, device="cuda") -> CPVGridPolicy:
    """A flax ``CPVGridPolicy``'s variables as the port's module (the cell
    count from ``dense0``'s ``H*W*32 + 6 + embed`` rows, as for
    ``GridPolicy``)."""
    p = variables["params"]
    embed = np.shape(p["task_embed"])[1]
    hw = (np.shape(p["dense0"]["kernel"])[0] - 6 - embed) // 32
    model = CPVGridPolicy(1, hw, channels=np.shape(p["conv0"]["kernel"])[3],
                          hidden=np.shape(p["dense0"]["kernel"])[1], embed_dim=embed,
                          device="meta")
    return _load_flax(model, variables, device)


def cpv_policy_from_numpy(variables: dict, height: int, width: int, with_init: bool = False,
                          device="cuda") -> CPVPolicy:
    """A flax ``CPVPolicy(height, width, with_init=...)``'s variables as the
    port's module (the flat family's tree does not hold the grid's shape)."""
    p = variables["params"]
    model = CPVPolicy(height, width, embed_dim=np.shape(p["task_embed"])[1],
                      hidden=np.shape(p["grid0"]["kernel"])[1], with_init=with_init,
                      device="meta")
    return _load_flax(model, variables, device)


def recurrent_actor_critic_from_numpy(variables: dict, device="cuda") -> RecurrentActorCritic:
    """A flax ``RecurrentActorCritic``'s variables as the port's module."""
    d_in, hidden = np.shape(variables["params"]["encoder"]["kernel"])
    return _load_flax(RecurrentActorCritic(d_in, hidden, device="meta"), variables, device)


def _scale_by_adam(state):
    """The ``ScaleByAdamState`` inside an optax state (a chain nests tuples
    of states; the clip and learning-rate states are empty)."""
    if hasattr(state, "mu"):
        return state
    found = [s for s in map(_scale_by_adam, state if isinstance(state, (tuple, list)) else ())
             if s is not None]
    return found[0] if len(found) == 1 else None


def _chain_adam_state(opt_state, device) -> AdamState:
    """optax ``chain(clip_by_global_norm, adam)``'s state (an empty clip
    state, then adam's: ``ScaleByAdamState`` with moments over the flax tree
    and an empty learning-rate state) as the port's ``AdamState``, keyed by
    the module's dotted parameter names."""
    adam = _scale_by_adam(opt_state)
    return adam_state_from_numpy({"count": adam.count,
                                  "mu": _flat_tree(adam.mu["params"]),
                                  "nu": _flat_tree(adam.nu["params"])}, device)


def bc_train_state_from_numpy(params: dict, opt_state, device="cuda") -> BCTrainState:
    """A JAX ``train/dagger.BCTrainState`` (flax variables and optax chain
    state, as numpy) as the port's; the family (``GridPolicy`` or
    ``CPVGridPolicy``, which holds ``task_embed``) is read from the tree."""
    from_numpy = (cpv_grid_policy_from_numpy if "task_embed" in params["params"]
                  else grid_policy_from_numpy)
    return BCTrainState(from_numpy(params, device), _chain_adam_state(opt_state, device))


def ppo_train_state_from_numpy(params: dict, opt_state, update_idx=0,
                               device="cuda") -> TrainState:
    """A JAX ``train/ppo.TrainState`` (flax variables, optax chain state and
    update index, as numpy) as the port's; the family (``GridActorCritic``
    holds ``pos``, ``ActorCritic`` ``torso0``, else ``PixelActorCritic``) is
    read from the tree."""
    p = params["params"]
    from_numpy = (grid_actor_critic_from_numpy if "pos" in p
                  else actor_critic_from_numpy if "torso0" in p
                  else pixel_actor_critic_from_numpy)
    return TrainState(from_numpy(params, device), _chain_adam_state(opt_state, device),
                      int(np.asarray(update_idx)))


def rnn_train_state_from_numpy(d: dict, device="cuda") -> RnnTrainState:
    """A JAX ``train/ppo_rnn.RnnTrainState`` as a dict of its fields (flax
    variables, optax chain state, ``hidden``, ``prev_done``, ``update_idx``;
    numpy) as the port's."""
    return RnnTrainState(
        params=recurrent_actor_critic_from_numpy(d["params"], device),
        opt_state=_chain_adam_state(d["opt_state"], device),
        hidden=torch.from_numpy(np.array(d["hidden"], dtype=np.float32)).to(device),
        prev_done=torch.from_numpy(np.array(d["prev_done"], dtype=bool)).to(device),
        update_idx=int(np.asarray(d["update_idx"])))


def flax_params_to_numpy(model: torch.nn.Module) -> dict:
    """A flax family's module as its flax variables, ``{"params": {...}}``."""
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy()
    return {"params": tree}

"""Spatial grid policy: the model family for solving canonical CraftingWorld.

Counterpart of ``gym_craftingworld_tpu/models/grid_policy.py``. The policy
reads 49 feature planes over the H x W grid (current objects 8, agent 1, init
objects 8, init-agent mark 1, broadcast holding and goal scalars 31) through
a bf16 conv torso (three 3x3 SAME convs and a 1x1 ``squeeze``), flattened
into dense layers with 33 extra scalars (the 31 scalars and the agent's row
and column over the grid size).

The planes are built two ways, bit-identical to each other: from stored
snapshot columns (``train/demos.py``, minibatch time) and from a live
``EnvState`` (evaluation and DAgger rollouts). Where JAX writes
``jax.nn.one_hot(x - 1, n)`` (a zero row for code 0) the port compares with
``arange``, as ``render/raster.py`` does; ``torch.nn.functional.one_hot``
raises on -1. The integer matmul of the goal masks is a multiply and an int32
sum: CUDA has no integer matmul.
"""

from __future__ import annotations

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import Conv, Dense

bf16 = torch.bfloat16
f32 = torch.float32
i32 = torch.int32

N_PLANES = 8 + 1 + 8 + 1 + 4 + 3 * C.N_TASKS  # 49
N_EXTRAS = 4 + 3 * C.N_TASKS + 2  # 33


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(x, n, dtype=bf16)``: a zero row where ``x`` is outside
    [0, n)."""
    return (x.to(i32)[..., None] == torch.arange(n, dtype=i32, device=x.device)).to(bf16)


def _scalar_features(holding, desired_bits, achieved_bits):
    """(holding one-hot, desired, achieved, residual) -> bf16[B, 31]."""
    hold_oh = _one_hot(holding, 4)
    des = desired_bits.to(bf16)
    ach = achieved_bits.to(bf16)
    res = des * (1 - ach)
    return torch.cat([hold_oh, des, ach, res], dim=-1)


def _assemble(cfg: EnvConfig, obj_p, agent_p, init_p, iagent_p, scal, agent_r, agent_c):
    """Shared tail: stack planes + broadcast scalars, build extras.

    The row and column are divided in bf16 by a tensor of the grid size: on
    CUDA, torch turns a division by a Python number into a product with its
    reciprocal, which can round differently from JAX's division.
    """
    B = agent_p.shape[0]
    HW = cfg.n_cells
    scal_planes = scal[:, None, :].expand(B, HW, scal.shape[-1])
    planes = torch.cat([obj_p, agent_p, init_p, iagent_p, scal_planes], dim=-1).reshape(
        B, cfg.height, cfg.width, N_PLANES)
    r, c = agent_r.to(bf16), agent_c.to(bf16)
    extras = torch.cat([scal, (r / torch.full_like(r, cfg.height))[:, None],
                        (c / torch.full_like(c, cfg.width))[:, None]], dim=-1)
    return planes, extras


def mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """int 9-bit masks [B] -> 0/1 rows int32[B, 9]."""
    bits = torch.arange(C.N_TASKS, dtype=i32, device=mask.device)
    return (mask.to(i32)[:, None] >> bits[None, :]) & 1


def planes_from_snaps(cfg: EnvConfig, occ_key, occ_code, init_key, init_agent_key, agent_key,
                      holding, desired_mask, achieved_mask):
    """Stored snapshot columns (``train/demos.SnapDataset`` rows) -> (planes, extras)."""
    HW = cfg.n_cells
    cell_oh = _one_hot(occ_key, HW)  # [B, 8, HW]; padded slots (key HW + 1) -> zero
    code_oh = _one_hot(occ_code.to(i32) - 1, C.N_OBJECTS)  # [B, 8, 8]; code 0 -> zero
    obj_p = cell_oh.transpose(1, 2) @ code_oh  # einsum("bsh,bsc->bhc"), 0/1 exact
    agent_key = agent_key.to(i32)
    agent_p = _one_hot(agent_key, HW)[..., None]
    init_p = _one_hot(init_key, HW).transpose(1, 2)  # slot s holds object code s+1 at reset
    iagent_p = _one_hot(init_agent_key, HW)[..., None]
    scal = _scalar_features(holding, mask_bits(desired_mask), mask_bits(achieved_mask))
    return _assemble(cfg, obj_p, agent_p, init_p, iagent_p, scal,
                     agent_key // cfg.width, agent_key % cfg.width)


def planes_from_state(cfg: EnvConfig, state: EnvState):
    """Live EnvState -> (planes, extras); bit-identical to planes_from_snaps."""
    B = state.objects.shape[0]
    HW = cfg.n_cells
    obj_p = _one_hot(state.objects.reshape(B, HW).to(i32) - 1, C.N_OBJECTS)
    agent_key = (state.agent[:, 0] * cfg.width + state.agent[:, 1]).to(i32)
    agent_p = _one_hot(agent_key, HW)[..., None]
    init_flat = state.init_objects.reshape(B, HW).to(i32)
    init_p = _one_hot(init_flat - 1, C.N_OBJECTS)
    iagent_p = (init_flat == C.AGENT_INIT_MARK).to(bf16)[..., None]
    scal = _scalar_features(state.holding, state.desired, state.achieved)
    return _assemble(cfg, obj_p, agent_p, init_p, iagent_p, scal,
                     state.agent[:, 0], state.agent[:, 1])


def snap_columns_from_state(cfg: EnvConfig, state: EnvState) -> dict:
    """On-device snapshot extraction (the DAgger rollout recorder).

    Returns the same columns ``train/demos.py`` stores, as tensors on the
    state's device: ``occ_key`` int16[B, 8], ``occ_code`` int8[B, 8],
    ``init_key`` int16[B, 8], ``init_agent_key``, ``agent_key`` int16[B],
    ``holding`` int8[B], ``desired``, ``achieved`` int16[B] 9-bit masks.
    """
    B = state.objects.shape[0]
    HW = cfg.n_cells
    dev = state.objects.device
    flat = state.objects.reshape(B, HW).to(i32)
    # occupied cells first, in cell order (a stable sort of the empty flags)
    order = torch.argsort((flat == 0).to(torch.int8), dim=1, stable=True)[:, : C.N_OBJECTS]
    code = flat.gather(1, order)
    occ_key = torch.where(code > 0, order, HW + 1).to(torch.int16)
    init_flat = state.init_objects.reshape(B, HW).to(i32)
    codes = torch.arange(1, C.N_OBJECTS + 1, dtype=i32, device=dev)
    init_key = torch.argmax((init_flat[:, None, :] == codes[None, :, None]).to(torch.int8),
                            dim=-1).to(torch.int16)
    init_agent_key = torch.argmax((init_flat == C.AGENT_INIT_MARK).to(torch.int8),
                                  dim=-1).to(torch.int16)
    bits = 2 ** torch.arange(C.N_TASKS, dtype=i32, device=dev)
    to_mask = lambda b: (b.to(i32) * bits).sum(-1, dtype=i32).to(torch.int16)
    return dict(
        occ_key=occ_key,
        occ_code=code.to(torch.int8),
        init_key=init_key,
        init_agent_key=init_agent_key,
        agent_key=(state.agent[:, 0] * cfg.width + state.agent[:, 1]).to(torch.int16),
        holding=state.holding.to(torch.int8),
        desired=to_mask(state.desired),
        achieved=to_mask(state.achieved),
    )


class GridPolicy(nn.Module):
    """Conv torso over the 49 feature planes + dense global reasoning.

    (planes [B, H, W, 49], extras [B, 33]) -> (logits f32[B, 6], value
    f32[B]). Parameters under the flax names (``conv0 conv1 conv2 squeeze
    dense0 dense1 policy value``).
    """

    def __init__(self, height: int = 21, width: int = 21, channels: int = 64, hidden: int = 1024,
                 n_actions: int = C.N_ACTIONS, in_planes: int = N_PLANES,
                 n_extras: int = N_EXTRAS, key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.conv0 = Conv(in_planes, channels, (3, 3), **kw("conv0"))
        self.conv1 = Conv(channels, channels, (3, 3), **kw("conv1"))
        self.conv2 = Conv(channels, channels, (3, 3), **kw("conv2"))
        self.squeeze = Conv(channels, 32, (1, 1), **kw("squeeze"))
        self.dense0 = Dense(height * width * 32 + n_extras, hidden, **kw("dense0"))
        self.dense1 = Dense(hidden, hidden // 2, **kw("dense1"))
        self.policy = Dense(hidden // 2, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden // 2, 1, dtype=f32, **kw("value"))

    def torso(self, x: torch.Tensor) -> torch.Tensor:
        """The conv stack, flattened in (h, w, c) order: bf16[B, H*W*32]."""
        for conv in (self.conv0, self.conv1, self.conv2, self.squeeze):
            x = torch.relu(conv(x))
        return x.reshape(x.shape[0], -1)

    def head(self, x: torch.Tensor):
        x = torch.relu(self.dense0(x))
        x = torch.relu(self.dense1(x))
        return self.policy(x), self.value(x)[:, 0]

    def forward(self, planes: torch.Tensor, extras: torch.Tensor):
        x = self.torso(planes.to(bf16))
        return self.head(torch.cat([x, extras.to(bf16)], dim=-1))


def init_grid_policy(key, cfg: EnvConfig, channels: int = 64, hidden: int = 1024) -> GridPolicy:
    """A ``GridPolicy`` for ``cfg``'s grid, its weights flax's
    ``model.init(key, ...)`` from JAX's key data ``key``, on its device."""
    return GridPolicy(cfg.height, cfg.width, channels, hidden, key=key)


def apply_from_state(model: nn.Module, cfg: EnvConfig, state: EnvState):
    """(logits, value) for a live batched EnvState."""
    return model(*planes_from_state(cfg, state))

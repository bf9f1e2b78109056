"""Recurrent actor-critic (GRU family).

Counterpart of ``gym_craftingworld_tpu/models/rnn.py``. The GRU carries a
per-env hidden state across the episode and resets it wherever an episode
boundary (``done``) occurred, before integrating the new observation.

The cell is flax's ``GRUCell(dtype=bf16)`` written out from ``Dense`` layers,
not ``torch.nn.GRUCell``, which fuses the gates into one weight, carries the
recurrent biases ``b_hr``/``b_hz`` that flax lacks and rounds elsewhere. Six
bf16 ``Dense`` layers under flax's names: ``ir iz in`` with a bias, ``hr hz``
without, ``hn`` with one; the recurrent kernels drawn by flax's
``orthogonal()``. Every step of the update is bf16::

    r = sigmoid(ir(x) + hr(h));  z = sigmoid(iz(x) + hz(h))
    n = tanh(in(x) + r * hn(h));  h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import Dense

bf16 = torch.bfloat16
f32 = torch.float32


class GRUCell(nn.Module):
    """flax ``nn.GRUCell(features, dtype=bf16)``: (h, x) -> h' in bf16."""

    def __init__(self, in_features: int, features: int, key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        for name in ("ir", "iz", "in"):
            setattr(self, name, Dense(in_features, features, key=child(rngs, name),
                                      device=device))
        for name in ("hr", "hz", "hn"):
            setattr(self, name, Dense(features, features, use_bias=name == "hn",
                                      init="orthogonal", key=child(rngs, name), device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    """obs encoder -> GRU -> policy/value heads, one step per call.

    (h f32[B, H], obs [B, D], done bool[B]) -> (h' f32[B, H], logits
    f32[B, 6], value f32[B]). Parameters under the flax names (``encoder``,
    ``gru.{ir,iz,in,hr,hz,hn}``, ``policy``, ``value``).
    """

    def __init__(self, in_features: int, hidden: int = 256, n_actions: int = C.N_ACTIONS,
                 key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.hidden = hidden
        self.encoder = Dense(in_features, hidden, **kw("encoder"))
        self.gru = GRUCell(hidden, hidden, **kw("gru"))
        self.policy = Dense(hidden, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden, 1, dtype=f32, **kw("value"))

    def forward(self, hidden: torch.Tensor, obs: torch.Tensor, done: torch.Tensor):
        x = torch.relu(self.encoder(obs.to(bf16)))
        # reset hidden at episode boundaries before integrating the new obs
        hidden = torch.where(done[:, None], torch.zeros_like(hidden), hidden)
        y = self.gru(hidden.to(bf16), x)
        return y.to(f32), self.policy(y), self.value(y)[:, 0]

    def initial_state(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self.hidden), dtype=f32,
                           device=self.encoder.kernel.device)


def init_params(key, feature_dim: int, hidden: int = 256) -> RecurrentActorCritic:
    """A ``RecurrentActorCritic`` over ``feature_dim`` features, its weights
    flax's ``model.init(key, ...)`` from JAX's key data, on the key's device."""
    return RecurrentActorCritic(feature_dim, hidden, key=key)

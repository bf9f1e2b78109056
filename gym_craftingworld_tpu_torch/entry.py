"""The flagship model's entry point: its forward over a batch of worlds.

Counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``:
``entry()`` builds the goal-conditioned actor-critic (``models/actor_critic``)
at ``ray_config()``, its weights flax's init from ``PRNGKey(0)``, and 64 worlds
from ``reset_from_seed(cfg, 0, 64)``, and returns ``(forward, (model,
state))``, where ``forward(model, state)`` maps the worlds' features to the
policy's logits and value. The multi-device dry run, the other half of that
file, is ``parallel/dryrun.py``'s ``dryrun_multichip``.

    python -m gym_craftingworld_tpu_torch.entry                 # on the card
    python -m gym_craftingworld_tpu_torch.entry --device cpu
"""

from __future__ import annotations

import argparse

import torch

from gym_craftingworld_tpu_torch.config import ray_config
from gym_craftingworld_tpu_torch.core.reset import reset_from_seed
from gym_craftingworld_tpu_torch.models.actor_critic import init_params, obs_features
from gym_craftingworld_tpu_torch.ops.threefry import prng_key


def entry(device="cuda"):
    """``(forward, (model, state))`` on ``device``."""
    cfg = ray_config()
    model = init_params(prng_key(0, device=device), cfg.height, cfg.width)
    state = reset_from_seed(cfg, 0, 64, device=device)

    def forward(model, state):
        """Env features -> policy logits and value for the whole batch."""
        return model(obs_features(state))

    return forward, (model, state)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    fn, inputs = entry(args.device)
    with torch.no_grad():
        out = fn(*inputs)
    print("entry forward:", [tuple(x.shape) for x in out])
    return out


if __name__ == "__main__":
    main()

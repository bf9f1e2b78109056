"""What the drivers share: the check steps' recording, and the faults that
the check's tests plant under the timed path."""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.ppo import Record
from benchmark.reference.world import FIELDS

TERMS = ("loss", "pg_loss", "v_loss", "entropy")


def host_env(env) -> dict:
    return {k: getattr(env, k).cpu().numpy() for k in FIELDS}


@contextlib.contextmanager
def wrapped(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(obj.name)`` for the block."""
    old = getattr(obj, name)
    setattr(obj, name, wrap(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def replaced(obj, name: str, value):
    """``obj.name`` replaced by ``value`` for the block."""
    return wrapped(obj, name, lambda _: value)


def stale(trainer):
    """A fault: the optimizer's updates dropped, so a step returns its
    parameters unchanged."""
    return replaced(trainer, "apply_updates", lambda params, updates: None)


def altered_token(trainer):
    """A fault: env 0's action altered where the collect samples it."""
    sample = trainer._sample_action

    def altered(u, logits):
        action, log_prob = sample(u, logits)
        action = action.clone()
        action[0] = (action[0] + 1) % logits.shape[0]
        return action, log_prob

    return replaced(trainer, "_sample_action", altered)


def recording(module, box: dict):
    """Keep, of the next iteration of the trainer ``module``: each action
    slab it hands its env step (``rollout_packed_actions``), the first
    minibatch's loss terms (``minibatch_grads``) and Adam's first moment
    after the first optimizer step (``make_optimizer``'s ``update``). Each
    call goes on unchanged."""

    def step(fn):
        def call(cfg, st, actions):
            box.setdefault("actions", []).append(actions[0].clone())
            return fn(cfg, st, actions)
        return call

    def grads(fn):
        def call(*args, **kwargs):
            g, aux = fn(*args, **kwargs)
            box.setdefault("loss", [float(aux[k]) for k in TERMS])
            return g, aux
        return call

    def optimizer(make):
        def call(*args, **kwargs):
            opt = make(*args, **kwargs)

            def update(g, state):
                updates, state = opt.update(g, state)
                box.setdefault("mu", {k: v.clone() for k, v in state.mu.items()})
                return updates, state

            return opt._replace(update=update)
        return call

    stack = contextlib.ExitStack()
    for name, wrap in (("rollout_packed_actions", step), ("minibatch_grads", grads),
                       ("make_optimizer", optimizer)):
        stack.enter_context(wrapped(module, name, wrap))
    return stack


def _clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


def check_steps(cell, module, steps: int) -> Record:
    """Run the cell's first ``steps`` units through its own call, recording
    what the reference follows and judges: each iteration's starting
    parameters and Adam state, sampled actions, first minibatch's loss and
    first moment, the worlds after it and its final parameters."""
    rec = Record(*([] for _ in Record._fields))
    for _ in range(steps):
        opt = cell.ts.opt_state
        rec.starts.append(_clone(cell.params()))
        rec.opts.append((_clone(opt.mu), _clone(opt.nu), opt.count.clone()))
        box = {}
        with recording(module, box):
            cell.unit()
        rec.actions.append(torch.stack(box["actions"]))
        rec.losses.append(box["loss"])
        rec.mu_first.append(box["mu"])
        rec.envs.append(host_env(cell.env))
        rec.ends.append(_clone(cell.params()))
    return rec

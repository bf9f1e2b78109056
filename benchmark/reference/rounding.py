"""Rounding points of the stated arithmetic, as autograd functions.

``round_to(x, fwd, bwd)`` rounds ``x`` to ``fwd`` (None: leaves it) in the
forward pass and its gradient to ``bwd`` (None: leaves it) in the backward
pass, computing in the tensors' own float32 otherwise. A configuration's
products of bf16 operands with float32 sums are float32 products of
operands rounded this way.
"""

from __future__ import annotations

import torch


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x if fwd is None else x.to(fwd).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else g.to(ctx.bwd).to(g.dtype)), None, None


def round_to(x: torch.Tensor, fwd, bwd=None) -> torch.Tensor:
    return _Round.apply(x, fwd, bwd)

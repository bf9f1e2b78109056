"""The training iteration's model FLOPs (``model_flops``) times the
iterations of the run's untraced window, over that window and the card's
dense bf16 peak."""

from benchmark import model_flops


def read(ctx):
    if ctx["traffic"]["entry"] != "train":
        return None
    flops = model_flops.train_iteration(ctx["conf"], ctx["traffic"]["envs"]) * ctx["units"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]["bf16_flop_per_s"]

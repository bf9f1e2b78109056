"""The minibatch gradient's work, 6 N (F H + H H + 7 H) for each minibatch of
N rows of the traced window, over the device time of the kernels that
compute it (``cw_ppo_grads``'s launches, by name), against the card's
dense bf16 peak: the products bound it."""

from benchmark.model_flops.fastppo import ppo_grads

KERNELS = ("cw_pad_kernel", "cw_transpose_kernel", "cw_heads_kernel", "cw_head_partial_kernel",
           "cw_reduce_kernel", "cw_wgmma_gemm")


def read(ctx):
    tr, conf = ctx.get("trace"), ctx["conf"]
    if tr is None or conf["family"] != "fastppo" or ctx["traffic"]["entry"] != "train":
        return None
    seconds = tr.kernel_time(KERNELS)
    if seconds <= 0:
        return None
    n = conf["rollout_steps"] * ctx["traffic"]["envs"] // conf["num_minibatches"]
    flops = ppo_grads(n, conf["features"], conf["hidden"])
    flops *= conf["update_epochs"] * conf["num_minibatches"] * tr.units
    return 100.0 * flops / seconds / ctx["peak"]["bf16_flop_per_s"]

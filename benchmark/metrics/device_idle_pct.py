"""The device's idle share of the traced window: 100 (1 - busy / window),
busy being the union of its kernels, copies and fills in the trace."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

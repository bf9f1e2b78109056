"""Env-steps completed in the window over the window (host clock): every
unit's env-steps, from the window's start to the synchronise after the last."""


def read(ctx):
    return ctx["units"] * ctx["work_per_unit"] / ctx["window_s"]

"""Set-up: from the process's start to the first timed unit (host clock)."""


def read(ctx):
    return ctx["setup_s"]

"""A whole solve: the forward window loss by the frozen step budget, its
backward at twice the forward, every step, at the FP32 peak over a solve's
wall time, in %."""

from portbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, ctx.shapes["ops"])

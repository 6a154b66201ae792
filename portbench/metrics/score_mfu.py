"""A whole scoring: the horizons' operations at the FP32 peak over the wall
time a scoring in the measured window, in %."""

from portbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, sum(v["ops"] for v in ctx.shapes["per_horizon"].values()))

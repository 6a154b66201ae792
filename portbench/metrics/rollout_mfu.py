"""A whole rollout call: its operations at the FP32 peak over its wall time
a call in the measured window, in %."""

from portbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, ctx.shapes["ops"])

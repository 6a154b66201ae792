"""K1 (``csrc/rollout.cu``, ``rollout_commands_kernel``): its bound at the
call's shape over its device time a call, in %."""

from portbench import opcounts
from portbench.readers import roofline_percent


def read(ctx):
    k = ctx.trace["window"].kernels("rollout_commands_kernel")
    if len(k) != ctx.trace["requests"]:
        return None
    s = ctx.shapes
    return roofline_percent(opcounts.bound_s(s["ops"], s["bytes"]), k, len(k))

"""K5 fused (``csrc/quat.cu``, ``window_staged_quat_kernel``): the horizons'
bounds over their device time, a scoring, in %."""

from portbench.readers import window_roofline


def read(ctx):
    return window_roofline(ctx, "window_staged_quat_kernel")

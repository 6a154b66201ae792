"""K2 fused (``csrc/window_eval.cu``, ``window_eval_kernel``): the horizons'
bounds over their device time, a scoring, in %."""

from portbench.readers import window_roofline


def read(ctx):
    return window_roofline(ctx, "window_eval_kernel")

"""The window kernel's launch wrapper on the host, a horizon: the mean
length of the span ``brov2.wrapper.launch`` (``ops/cuda_eval.py::
launch_window_sq``, ``ops/cuda_quat.py::launch_window_sq_quat``: checks,
library, device context, scratch, the ctypes call) over the traced
scorings, in us."""

from portbench.spans import score_mean_us


def read(ctx):
    return score_mean_us(ctx, "brov2.wrapper.launch")

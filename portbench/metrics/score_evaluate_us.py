"""A scoring's evaluator call, a horizon: the mean length of the span
``brov2.evaluate`` (``apps/common.py::endpoint_evaluator_with_kernel``'s
``run(H)``) over the traced scorings, in us."""

from portbench.spans import score_mean_us


def read(ctx):
    return score_mean_us(ctx, "brov2.evaluate")

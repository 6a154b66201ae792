"""The RMSE epilogue on the host, a horizon: the mean length of the span
``brov2.wrapper.rmse`` (``apps/common.py::fused_rmse``'s divide and sqrt)
over the traced scorings, in us."""

from portbench.spans import score_mean_us


def read(ctx):
    return score_mean_us(ctx, "brov2.wrapper.rmse")

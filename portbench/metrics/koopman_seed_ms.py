"""Mean length in ms of the span ``brov2.koopman.seed``, the k-means++
seeding (``ops/kmeans.py::_kmeanspp_init``: a draw a center after the
first, one after the other), over the traced fits: one a fit, else
nothing."""

from portbench.spans import counted


def read(ctx):
    n = ctx.trace["requests"]
    found = counted(ctx, ctx.trace["window"], "brov2.koopman.seed", n)
    return 1e-6 * sum(e - s for s, e in found) / n if found else None

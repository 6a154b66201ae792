"""Mean length in ms of the span ``brov2.koopman.lloyd``, the Lloyd rounds
and the final assignment (``ops/kmeans.py::kmeans``), over the traced fits:
one a fit, else nothing."""

from portbench.spans import counted


def read(ctx):
    n = ctx.trace["requests"]
    found = counted(ctx, ctx.trace["window"], "brov2.koopman.lloyd", n)
    return 1e-6 * sum(e - s for s, e in found) / n if found else None

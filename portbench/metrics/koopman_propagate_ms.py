"""Mean length in ms of the span ``brov2.koopman.propagate``
(``models/koopman.py::multistep_rmse``'s H steps: the host's launches of
the propagation, which the device runs behind), over the traced scorings:
one a horizon of every scoring, else nothing."""

from portbench.spans import counted


def read(ctx):
    n = ctx.trace["requests"] * len(ctx.shapes["horizons"])
    found = counted(ctx, ctx.trace["window"], "brov2.koopman.propagate", n)
    return 1e-6 * sum(e - s for s, e in found) / n if found else None

"""Mean length in ms of the span ``brov2.koopman.normal_eqns``, the ridge
normal equations (``models/koopman.py::_ridge_solve``: the float64 Gram,
its right-hand side and the Cholesky solve), over the traced fits: one a
fit, else nothing."""

from portbench.spans import counted


def read(ctx):
    n = ctx.trace["requests"]
    found = counted(ctx, ctx.trace["window"], "brov2.koopman.normal_eqns", n)
    return 1e-6 * sum(e - s for s, e in found) / n if found else None

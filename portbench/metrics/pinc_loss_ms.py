"""Mean length in ms of the span ``brov2.pinc.loss``, the minibatch's gather
and loss (``models/pinc.py::_loss``), over the longer traced training: one a
minibatch, else nothing."""

from portbench.spans import counted


def read(ctx):
    hi = ctx.shapes["trace_steps"][-1]
    found = counted(ctx, ctx.trace[f"fit{hi}"], "brov2.pinc.loss", hi)
    return 1e-6 * sum(e - s for s, e in found) / hi if found else None

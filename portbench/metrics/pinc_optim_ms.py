"""Mean length in ms of the span ``brov2.pinc.optim``, the minibatch's clipped
AdamW update (``AdamWClip.step``), over the longer traced training: one a
minibatch, else nothing."""

from portbench.spans import counted


def read(ctx):
    hi = ctx.shapes["trace_steps"][-1]
    found = counted(ctx, ctx.trace[f"fit{hi}"], "brov2.pinc.optim", hi)
    return 1e-6 * sum(e - s for s, e in found) / hi if found else None

"""One replayed PINc minibatch step's wall time: the one span
``brov2.pinc.replay`` (``models/pinc.py::_CapturedStep``: every replay of
the call and the closing synchronise) of the longer traced training over
its minibatches, in ms."""

from portbench.spans import fit_span


def read(ctx):
    s = fit_span(ctx, "brov2.pinc.replay")
    return None if s is None else 1e-6 * (s[1] - s[0]) / ctx.shapes["trace_steps"][-1]

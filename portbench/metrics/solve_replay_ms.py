"""One replayed Adam iteration's wall time: the one span
``brov2.sysid.replay`` (``models/sysid.py::_run_adam``'s replays and the
closing synchronise) of the longer traced fit over its steps, in ms."""

from portbench.spans import fit_span


def read(ctx):
    s = fit_span(ctx, "brov2.sysid.replay")
    return None if s is None else 1e-6 * (s[1] - s[0]) / ctx.shapes["trace_steps"][-1]

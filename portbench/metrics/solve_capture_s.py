"""A fit's graph capture: the length of the one span ``brov2.sysid.capture``
(``models/sysid.py::_run_adam``: the state saved, the side-stream warm-up
iterations, the capture of one iteration) in the longer traced fit, in s."""

from portbench.spans import fit_span


def read(ctx):
    s = fit_span(ctx, "brov2.sysid.capture")
    return None if s is None else 1e-9 * (s[1] - s[0])

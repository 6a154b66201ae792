"""A PINc training's graph capture: the length of the one span
``brov2.pinc.capture`` (``models/pinc.py::_CapturedStep``: the state saved,
the side-stream warm-up step, the capture of one minibatch step) in the
longer traced training, in s."""

from portbench.spans import fit_span


def read(ctx):
    s = fit_span(ctx, "brov2.pinc.capture")
    return None if s is None else 1e-9 * (s[1] - s[0])

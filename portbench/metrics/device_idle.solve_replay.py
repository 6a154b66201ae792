"""The device's idle share inside the replays of the longer traced fit, in
%: 1 - the busy time inside the span ``brov2.sysid.replay`` over its length.
Whether the replayed graph of one Adam iteration keeps the device busy or
leaves gaps between its kernels."""

from portbench.spans import busy_s, fit_span, fit_trace


def read(ctx):
    s = fit_span(ctx, "brov2.sysid.replay")
    if s is None:
        return None
    return 100.0 * (1.0 - busy_s(fit_trace(ctx), s) / (1e-9 * (s[1] - s[0])))

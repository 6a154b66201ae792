"""The lag-filter history of a fit: the length of the one span
``brov2.sysid.lag_history`` (``models/sysid.py::lag_history``) in the
longer traced fit, in s."""

from portbench.spans import fit_span


def read(ctx):
    s = fit_span(ctx, "brov2.sysid.lag_history")
    return None if s is None else 1e-9 * (s[1] - s[0])

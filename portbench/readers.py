"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

from portbench import opcounts


def idle_percent(trace):
    """The device's idle share of a traced window, in %; None where the trace
    holds no device event."""
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def roofline_percent(bound_s: float, kernels, calls: int):
    """``calls`` calls' bound over the device time of ``kernels`` (their
    events), in %; None without events."""
    t = 1e-9 * sum(e - s for _, s, e in kernels)
    return 100.0 * calls * bound_s / t if kernels and t > 0 else None


def mfu_percent(ctx, ops: float):
    """``ops`` at the FP32 peak over the window's wall time a request, in %;
    None off the card."""
    if not ctx.on_card:
        return None
    return 100.0 * ops / opcounts.PEAK_FLOPS / ctx.window["wall_per_request_s"]


def window_roofline(ctx, kernel: str):
    """A window kernel's share over a scoring: the horizons' bounds over the
    device time of the kernels named ``kernel`` in the traced scorings."""
    tr = ctx.trace["window"]
    k = tr.kernels(kernel)
    per = ctx.shapes["per_horizon"]
    if len(k) != ctx.trace["requests"] * len(per):
        return None
    bound = sum(opcounts.bound_s(v["ops"], v["bytes"]) for v in per.values())
    return roofline_percent(bound, k, ctx.trace["requests"])

"""Arithmetic of the spans the program records in its trace.

The port names its layers with ``torch.profiler.record_function`` ranges
(``utils/profiling.py::span``): host events of the traced window's thread,
on the clock of the device's kernels.  A reader takes the intervals of one
span name, refuses a count other than the one the traced segment implies
(a span moved, added or lost reads as nothing, not as another number), and
reads their lengths or the device's busy time inside them.  Off the card
every reader reads nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.trace import Trace

Interval = Tuple[int, int]


def intervals(trace: Trace, name: str) -> List[Interval]:
    """``(start_ns, end_ns)`` of the host events named ``name``, in order."""
    return [(s, e) for n, s, e in trace.host if n == name]


def busy_s(trace: Trace, span: Interval) -> float:
    """Seconds of the union of device events inside ``span``, each clipped
    to it as :meth:`Trace.busy_intervals` clips to the window."""
    return Trace(trace.device, [], span).busy_s()


def counted(ctx, trace: Trace, name: str, count: int) -> Optional[List[Interval]]:
    """The spans ``name`` of ``trace``, or None off the card or where there
    are not exactly ``count`` of them."""
    if not ctx.on_card:
        return None
    found = intervals(trace, name)
    return found if len(found) == count else None


def score_mean_us(ctx, name: str) -> Optional[float]:
    """Mean length in us of the span ``name`` over the traced scorings: one
    a horizon of every request."""
    found = counted(ctx, ctx.trace["window"], name,
                    ctx.trace["requests"] * len(ctx.shapes["horizons"]))
    if not found:
        return None
    return 1e-3 * sum(e - s for s, e in found) / len(found)


def fit_trace(ctx) -> Trace:
    """The trace of the longer of the solve's two traced fits."""
    return ctx.trace[f"fit{ctx.shapes['trace_steps'][-1]}"]


def fit_span(ctx, name: str) -> Optional[Interval]:
    """The one span ``name`` of the longer traced fit, or None."""
    found = counted(ctx, fit_trace(ctx), name, 1)
    return found[0] if found else None

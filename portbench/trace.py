"""The profiler's trace, reduced to what the per-layer metrics read.

:func:`profiled` runs a function under ``torch.profiler`` (host and device
activity) inside a span of the benchmark's own; :class:`Trace` keeps the
device events (kernels, copies, sets) and the host events of that span's
thread as ``(name, start_ns, end_ns)``, and gives the union of the device's
busy intervals, the time by device operation and the idle gaps by what the
host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

WINDOW_SPAN = "portbench.window"

Event = Tuple[str, int, int]


# host events of the profiler's own bookkeeping, not of the program
PROFILER_OWN = frozenset({"Activity Buffer Request"})
NAME_CHARS = 160              # a breakdown entry's name is cut to this length


def _raw_events(prof):
    """``(name, is_device, start_ns, end_ns, thread)`` of every event but the
    device timeline's copies of the benchmark's own spans."""
    from torch.autograd import DeviceType

    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            dev = e.device_type() != DeviceType.CPU
            if dev and (e.is_user_annotation() or e.name() == WINDOW_SPAN):
                continue
            start = e.start_ns()
            out.append((e.name(), dev, start, start + e.duration_ns(), e.start_thread_id()))
        return out
    for e in prof.events():
        dev = e.device_type != DeviceType.CPU
        if dev and (e.is_user_annotation or e.name == WINDOW_SPAN):
            continue
        start = int(e.time_range.start * 1000)
        out.append((e.name, dev, start, int(e.time_range.end * 1000), e.thread))
    return out


class Trace:
    """One traced window: device events and the host events of its thread."""

    def __init__(self, device: List[Event], host: List[Event], window: Tuple[int, int]):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: (e[1], -e[2]))
        self.window = window

    @property
    def window_s(self) -> float:
        return 1e-9 * (self.window[1] - self.window[0])

    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        merged: List[List[int]] = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return 1e-9 * sum(e - s for s, e in self.busy_intervals())

    def kernels(self, fragment: str = "") -> List[Event]:
        """Device kernels (no copies or sets) whose name holds ``fragment``."""
        return [e for e in self.device if fragment in e[0] and not is_copy_or_set(e[0])]

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time: ``[name, s]``."""
        tot = defaultdict(int)
        for name, s, e in self.device:
            tot[name] += e - s
        return _top(tot, n)

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time of the device inside the window, summed by the innermost
        host event running at each gap's middle: ``[name, s]``, the ``n``
        largest."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = sorted(((edges[i] + edges[i + 1]) // 2, edges[i + 1] - edges[i])
                      for i in range(0, len(edges), 2) if edges[i + 1] > edges[i])
        starts = [h[1] for h in self.host]
        tot = defaultdict(int)
        stack: List[Event] = []
        j = 0
        for mid, length in gaps:
            j_new = bisect.bisect_right(starts, mid, lo=j)
            for h in self.host[j:j_new]:
                while stack and stack[-1][2] <= h[1]:
                    stack.pop()
                stack.append(h)
            j = j_new
            while stack and stack[-1][2] < mid:
                stack.pop()
            tot[stack[-1][0] if stack else "host: between ops"] += length
        return _top(tot, n)


def _top(tot: dict, n: int) -> List[list]:
    """The ``n`` largest ``[name, seconds]`` of nanosecond sums."""
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:NAME_CHARS], 1e-9 * v] for k, v in ranked]


def is_copy_or_set(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def profiled(fn: Callable, device_activity: bool = True) -> Trace:
    """Run ``fn()`` under the profiler, inside the span :data:`WINDOW_SPAN`,
    ended by a synchronise; its :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_activity:
        acts.append(ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if device_activity else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            sync()
    raw = _raw_events(prof)
    spans = [r for r in raw if r[0] == WINDOW_SPAN and not r[1]]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    _, _, w0, w1, tid = spans[0]
    device = [(n, s, e) for n, dev, s, e, _ in raw if dev]
    host = [(n, s, e) for n, dev, s, e, t in raw
            if not dev and t == tid and n != WINDOW_SPAN and n not in PROFILER_OWN]
    return Trace(device, host, (w0, w1))

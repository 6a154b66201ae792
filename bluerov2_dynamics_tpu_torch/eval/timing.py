"""Completion-correct timing for work on the card.

Counterpart of ``bluerov2_dynamics_tpu/eval/timing.py``.  PyTorch returns
before the device finishes, so a host clock must end on a synchronise;
:func:`cuda_event_time` times many launches between CUDA events instead,
which measures the device's own time, and :func:`device_ms` reads the
profiler's device events, for work shorter than its launcher's host time.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for r in result:
            yield from _tensors(r)
    elif isinstance(result, dict):
        for r in result.values():
            yield from _tensors(r)


def sync(result):
    """Force completion of ``result``'s computation: ``synchronize`` every
    CUDA device it lives on, then read one element back to the host.
    Returns ``result``."""
    seen = set()
    for t in _tensors(result):
        if t.is_cuda and t.device not in seen and t.numel():
            seen.add(t.device)
            torch.cuda.synchronize(t.device)
            t.reshape(-1)[0].item()
    return result


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 1, **kwargs):
    """Host-clock time of ``fn(*args, **kwargs)``: ``(result, seconds per
    call)`` over ``iters`` completion-forced calls after ``warmup``."""
    result = None
    for _ in range(max(warmup, 0)):
        result = sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(max(iters, 1)):
        result = sync(fn(*args, **kwargs))
    return result, (time.perf_counter() - t0) / max(iters, 1)


def time_fn_cold_warm(fn: Callable, *args, iters: int = 1, **kwargs):
    """Host-clock times of ``fn(*args, **kwargs)``: the first call (which
    builds, compiles or warms caches) and the mean of ``iters`` calls
    after it, each completion-forced by :func:`sync` (on the card a
    synchronise).  Returns ``(result, cold_seconds, warm_seconds)``."""
    t0 = time.perf_counter()
    result = sync(fn(*args, **kwargs))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(max(iters, 1)):
        result = sync(fn(*args, **kwargs))
    return result, cold, (time.perf_counter() - t0) / max(iters, 1)


def cuda_event_time(fn: Callable, iters: int = 10, warmup: int = 1) -> float:
    """Device milliseconds per call of ``fn()``, averaged over ``iters``
    launches between two CUDA events on the current stream, after
    ``warmup`` calls.  Needs a card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_time needs a CUDA device")
    for _ in range(max(warmup, 0)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(max(iters, 1)):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / max(iters, 1)


def host_ms(fn: Callable, calls: int = 50, warmup: int = 1) -> list:
    """Host milliseconds of each of ``calls`` calls of ``fn()``, each ended
    by a ``torch.cuda.synchronize()``, after ``warmup`` calls."""
    for _ in range(max(warmup, 0)):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def profile_calls(fn: Callable, calls: int = 20):
    """``torch.profiler`` over ``calls`` calls of ``fn`` after one warm-up:
    ``(device events, host microseconds of the window)``; no events where
    the profiler cannot trace the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        return [], 0.0
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], wall_us


def device_ms(fn: Callable, calls: int = 20):
    """Mean device milliseconds a call of ``fn`` (its kernels, copies and
    sets as the profiler traces them), or None without device events.  A
    kernel shorter than its launcher's host time cannot be timed by CUDA
    events around back-to-back calls: the device waits on the host."""
    dev, _ = profile_calls(fn, calls)
    return 1e-3 * sum(e.time_range.elapsed_us() for e in dev) / calls if dev else None

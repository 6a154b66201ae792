"""What the two Koopman kinds (``koopman_fit``, ``koopman_score``) share.

The recording's two splits, the fit's settings from the configuration, the
program's fit as the T2 app calls it, and a traced segment that also names
the device work each span of the port launched: the profiler links every
device event to the host operation that launched it (its correlation id),
and an operation inside a span's interval on the traced thread belongs to
that span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from portbench import recording
from portbench.reference import koopman as rk


def splits(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """``{"train": (X, U), "test": (X, U)}`` of the recording the traffic
    describes, float32 on ``device`` (the program and the reference read the
    same values)."""
    X, U = recording.generate(cfg, traffic, seed)
    out = {}
    for part in ("train", "test"):
        t = {"recording": dict(traffic["recording"], part=part)}
        out[part] = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                          for a in recording.split(t, X, U))
    return out


def fit_kwargs(cfg: dict) -> dict:
    """``koopman.fit``'s keywords from the configuration."""
    k = rk.settings(cfg)
    return dict(n_rbfs=int(k["n_rbfs"]), gamma=float(k["gamma"]), ridge=float(k["ridge"]),
                kmeans_iters=int(k["kmeans_iters"]))


def widths(cfg: dict):
    """``(n, r, k, d)``: states, inputs, centers, the lift's width."""
    k = rk.settings(cfg)
    return (int(k["state_width"]), int(k["input_width"]), int(k["n_rbfs"]),
            int(k["lift_dim"]))


def program_fit(cfg: dict, X, U, seed: int, gen: torch.Generator):
    """The port's fit as ``apps/common.py::fit_koopman_from_args`` makes it:
    the generator re-seeded, then ``koopman.fit``."""
    from bluerov2_dynamics_tpu_torch.models import koopman

    gen.manual_seed(seed)
    return koopman.fit(gen, X, U, **fit_kwargs(cfg))


def seed_rows(cfg: dict, X, seed: int):
    """The program's k-means++ seed rows for ``seed``: its ``kmeans`` with no
    Lloyd round, from a generator on ``X``'s device seeded as a fit seeds it."""
    from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans

    gen = torch.Generator(X.device).manual_seed(seed)
    return kmeans(X, fit_kwargs(cfg)["n_rbfs"], 0, gen)[0]


def profiled(fn, on_card: bool, names) -> dict:
    """Run ``fn()`` under the profiler as ``portbench.trace.profiled`` does;
    ``{"window": Trace, "launched": {span: [[(event, op, start_ns, end_ns),
    ...] for each occurrence of the span]}}`` for the spans ``names``, each
    occurrence's device events with the host operation that launched them.
    One pass over the profiler's events gives both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW_SPAN):
            fn()
            sync()
    events = list(prof.profiler.kineto_results.events())
    raw = []
    for e in events:
        dev = e.device_type() != DeviceType.CPU
        if not (dev and (e.is_user_annotation() or e.name() == tr.WINDOW_SPAN)):
            raw.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.start_thread_id()))
    spans = [r for r in raw if r[0] == tr.WINDOW_SPAN and not r[1]]
    if not spans:
        raise RuntimeError(f"the trace holds no {tr.WINDOW_SPAN} span")
    _, _, w0, w1, tid = spans[0]
    device = [(n, s, e) for n, dev, s, e, _ in raw if dev]
    host = [(n, s, e) for n, dev, s, e, t in raw
            if not dev and t == tid and n != tr.WINDOW_SPAN and n not in tr.PROFILER_OWN]
    return {"window": tr.Trace(device, host, (w0, w1)),
            "launched": launched(events, tid, names)}


def launched(events, tid: int, names) -> dict:
    """For each span name, each occurrence's device events ``(name, op,
    start_ns, end_ns)``, where ``op`` is the host operation of thread
    ``tid`` that launched the event and lies inside the span."""
    from torch.autograd import DeviceType

    ops, by_op = [], defaultdict(list)
    for e in events:
        s = e.start_ns()
        on_device = e.device_type() != DeviceType.CPU
        if on_device and not e.is_user_annotation():
            by_op[e.linked_correlation_id()].append((e.name(), s, s + e.duration_ns()))
        elif not on_device and e.start_thread_id() == tid and e.linked_correlation_id() == 0:
            ops.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
    ops.sort()
    starts = [o[0] for o in ops]
    out = {}
    for name in names:
        out[name] = []
        for lo, hi, _, _ in (o for o in ops if o[2] == name):
            inside = ops[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
            found = [(k, op, s, e) for _, end, op, cid in inside if end <= hi
                     for k, s, e in by_op.get(cid, ())]
            out[name].append(sorted(found, key=lambda f: f[2]))
    return out

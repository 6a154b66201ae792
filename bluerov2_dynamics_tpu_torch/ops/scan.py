"""Step loops: an eager loop on the CPU, replays of CUDA graphs on the card.

The JAX package writes every filter and smoother as one ``lax.scan``.
Here :func:`scan` runs ``f(carry, x_t) -> (carry, y_t)`` over the rows of
``xs`` and stacks the ``y_t``.  On the CPU that is a Python loop (the
plain version).  On a CUDA device a fixed chunk of :data:`GRAPH_CHUNK`
steps (64: a capture costs the host as much as the eager loop over its
steps, a replay a few microseconds beside the chunk's work) is captured once as a ``torch.cuda.CUDAGraph``, after a few warm-up
steps on a side stream, and replayed over the run: the inputs are copied
into static buffers before each replay and the outputs out of them after
it, the padded tail of the last chunk is dropped.  The body must not
synchronise with the host.  A capture that fails raises: there is no
quiet return to the eager loop.  A graph's kernels are the eager loop's
kernels in the same order, so the two give the same bits.

``draw(start, stop)`` supplies inputs made at run time (random draws),
chunk by chunk and in the same order on both paths, so that a run never
holds the whole run's draws at once.

A loop that is not a scan (an optimiser's iteration, a sampling round)
runs through :func:`capture`: its body is a function of static buffers,
captured once and replayed.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from bluerov2_dynamics_tpu_torch.ops._build import launches

GRAPH_CHUNK = 64     # steps captured in one CUDA graph and replayed
WARMUP_STEPS = 3     # steps run on a side stream before a capture

# host seconds spent warming up and capturing CUDA graphs, summed over every
# capture in the process (a caller reads it before and after a call).  A
# caller that sets STATS["keep"] finds the next captured graph's replay in
# STATS["replay"] (its inputs and outputs as the run left them), to trace
# one replay; the entry holds the graph and its buffers alive until it is
# removed.
STATS = {"capture_s": 0.0}


# one side stream a device for every warm-up: cuBLAS keeps a workspace (tens
# of MB) for each stream it has run on, so a new stream each capture would
# hold one more, up to the 32 of PyTorch's stream pool
_SIDE_STREAMS = {}


def _side_stream(device) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[device]


def add_capture(seconds: float) -> None:
    """Account one capture's warm-up and capture seconds in :data:`STATS`."""
    STATS["capture_s"] += seconds


def capture(fns: Sequence[Callable], state: Sequence[torch.Tensor], graph: bool,
            stats: Optional[dict] = None, names: Optional[Sequence[str]] = None,
            warmup: int = 1) -> list:
    """Each of ``fns`` (functions of no argument that read and write the
    tensors of ``state`` in place and return tensors) as a callable: the
    function itself, or with ``graph`` the replay of its CUDA graph, which
    returns the outputs of the capture (static tensors, overwritten by the
    next replay).  ``warmup`` rounds of calls run on a side stream first
    and the state they change is restored.  A failed capture raises.  The
    kernels' launch counts (``ops._build.launches``) count what the device
    runs: a capture launches nothing, and each replay what its capture
    recorded.  ``stats`` receives the capture's host seconds and, with
    ``stats["keep"]`` set, the replays under ``stats["replay"]`` (keyed by
    ``names``), to trace them."""
    if not graph:
        return list(fns)
    t0 = time.perf_counter()
    dev = state[0].device
    saved = [t.detach().clone() for t in state]
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(warmup):
            for f in fns:
                f()
    main.wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    runs = []
    for f in fns:
        counted = dict(launches)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = f()
        recorded = [(k, n - counted[k]) for k, n in launches.items() if n != counted[k]]
        launches.update(counted)
        runs.append(_replay(g, out, recorded, state))
    secs = time.perf_counter() - t0
    add_capture(secs)
    if stats is not None:
        stats["capture_s"] = stats.get("capture_s", 0.0) + secs
        if stats.pop("keep", False):
            stats["replay"] = dict(zip(names or range(len(runs)), runs))
    return runs


def _replay(g, out, recorded, state):
    """The replay of the graph ``g``: it returns the capture's outputs
    ``out`` and counts the launches the capture ``recorded``."""
    def run():
        g.replay()
        for k, n in recorded:
            launches[k] += n
        return out
    run.state = state       # the tensors the graph reads and writes live as long as it
    return run


def use_graph(graph: Optional[bool], device: torch.device, mesh=None) -> bool:
    """``graph`` resolved for tensors on ``device``: ``None`` means CUDA
    graphs exactly on a CUDA device with no ``mesh``; ``True`` off CUDA or
    with a mesh raises (a mesh's loops run eagerly)."""
    if graph is None:
        return device.type == "cuda" and mesh is None
    if graph and mesh is not None:
        raise ValueError("a CUDA graph runs on one device; a mesh runs eagerly")
    if graph and device.type != "cuda":
        raise ValueError("graph=True needs CUDA tensors")
    return bool(graph)


def _rows(xs: Sequence[torch.Tensor], t: int):
    return tuple(x[t] for x in xs)


def _scan_eager(f, carry, xs, n, chunk, draw):
    ys = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        block = [x[s:e] for x in xs] + (list(draw(s, e)) if draw is not None else [])
        for t in range(e - s):
            carry, y = f(carry, _rows(block, t))
            ys.append(y)
    return tuple(torch.stack([y[i] for y in ys]) for i in range(len(ys[0])))


def _scan_graph(f, carry, xs, n, chunk, draw):
    t0 = time.perf_counter()
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    first = list(draw(0, chunk)) if draw is not None else []
    static_x = [x[:chunk].clone() for x in xs] + [d.clone() for d in first]
    static_carry = [c.clone() for c in carry]
    device = static_x[0].device
    stream = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):          # warm-up off the capture, as CUDA graphs need
        c = tuple(t.clone() for t in carry)
        for t in range(min(WARMUP_STEPS, chunk)):
            c, y = f(c, _rows(static_x, t))
    stream.wait_stream(side)
    static_y = [torch.empty((chunk, *v.shape), dtype=v.dtype, device=v.device) for v in y]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = tuple(static_carry)
        for t in range(chunk):
            c, y = f(c, _rows(static_x, t))
            for buf, v in zip(static_y, y):
                buf[t].copy_(v)
        for buf, v in zip(static_carry, c):
            buf.copy_(v)
    add_capture(time.perf_counter() - t0)
    outs = [torch.empty((n, *b.shape[1:]), dtype=b.dtype, device=b.device) for b in static_y]
    for k in range(n_chunks):
        s, e = k * chunk, min((k + 1) * chunk, n)
        drawn = first if k == 0 else list(draw(s, e)) if draw is not None else []
        for sx, v in zip(static_x, [x[s:e] for x in xs] + drawn):
            sx[: e - s].copy_(v)
            if e - s < chunk:
                sx[e - s:].zero_()      # the padded tail's outputs are dropped
        graph.replay()
        for o, b in zip(outs, static_y):
            o[s:e].copy_(b[: e - s])
    stream.synchronize()
    if STATS.pop("keep", False):
        # the replay holds the graph and the buffers it reads and writes alive
        STATS["replay"] = lambda g=graph, held=(static_x, static_y, static_carry): g.replay()
    return tuple(outs)


def scan(f: Callable, carry, xs: Sequence[torch.Tensor], *, graph: Optional[bool] = None,
         chunk: int = GRAPH_CHUNK, reverse: bool = False,
         draw: Optional[Callable] = None):
    """The stacked ``y_t`` of ``f(carry, x_t) -> (carry, y_t)`` over the
    rows of ``xs`` (a tuple of tensors with the steps on their first
    axis), each ``y_t`` a tuple of tensors; ``reverse`` runs the steps
    last to first and returns the outputs in the inputs' order (the
    ``reverse=True`` of ``lax.scan``).  ``draw(start, stop)`` returns
    further inputs for steps ``start:stop`` (not with ``reverse``).
    ``graph`` as :func:`use_graph` resolves it."""
    xs = tuple(xs)
    n = xs[0].shape[0]
    if n == 0:
        raise ValueError("scan needs at least one step")
    if reverse and draw is not None:
        raise ValueError("a reversed scan takes no draws")
    if reverse:
        xs = tuple(torch.flip(x, dims=(0,)) for x in xs)
    run = _scan_graph if use_graph(graph, xs[0].device) else _scan_eager
    ys = run(f, tuple(carry), xs, n, chunk, draw)
    return tuple(torch.flip(y, dims=(0,)) for y in ys) if reverse else ys

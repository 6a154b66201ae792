"""Profiling and numerical-hygiene utilities.

Counterpart of ``bluerov2_dynamics_tpu/utils/profiling.py``: a
``torch.profiler`` trace written as a Chrome trace, the port's named
spans in it, a synchronised steps/sec counter, and explicit
finite-checks over nested containers of tensors or arrays.  The
containers are walked as JAX flattens a pytree:
dicts by sorted key, lists and tuples by index, NamedTuples by field,
``None`` as empty; a failing leaf is named by the path string
``jax.tree_util.keystr`` gives (``['a'][0].field``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# what span() returns while no profiler records: one object, reused, so an
# unprofiled call allocates nothing and makes no dispatcher call
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card where CUDA is available) and write it to ``log_dir`` as a Chrome
    trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def span(name: str):
    """A range named ``name`` in the profiler's trace, around a ``with``
    block: ``torch.profiler.record_function(name)`` while a profiler
    records (its host event on the same clock as the device's kernels, so
    :func:`trace` and a reader of the trace see it), otherwise one shared
    no-op context.  A bare ``record_function`` makes a dispatcher call
    even with no profiler running, which the guard avoids.  Never place
    one inside a body captured as a CUDA graph: the capture records it
    once and a replay never runs it."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _sync(tree) -> None:
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)


class StepsPerSecond:
    """Throughput counter: ``with StepsPerSecond(n_steps) as c: ...``;
    ``c.done(result)`` synchronises the devices of the tensors in
    ``result`` before it reads the clock."""

    def __init__(self, steps: int):
        self.steps = steps
        self.rate = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def done(self, result):
        _sync(result)
        self.rate = self.steps / (time.perf_counter() - self._t0)
        return result

    def __exit__(self, *exc):
        return False


def _leaves(tree, path: str = "") -> List[Tuple[str, object]]:
    """``(keystr path, leaf)`` pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _leaves(getattr(tree, name), f"{path}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _finite(leaf) -> Tuple[int, int]:
    """(elements, non-finite elements) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return leaf.numel(), 0
        return leaf.numel(), int((~torch.isfinite(leaf)).sum())
    a = np.asarray(leaf)
    if not np.issubdtype(a.dtype, np.inexact):
        return a.size, 0
    return a.size, int((~np.isfinite(a)).sum())


def check_finite(tree, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf (in JAX's
    flattening order) that holds a non-finite value."""
    for path, leaf in _leaves(tree):
        if _finite(leaf)[1]:
            raise FloatingPointError(f"non-finite values in {name}{path}")


def fraction_nonfinite(tree) -> float:
    """Fraction of non-finite elements across all leaves (diagnostics)."""
    total = bad = 0
    for _, leaf in _leaves(tree):
        n, b = _finite(leaf)
        total += n
        bad += b
    return bad / max(total, 1)

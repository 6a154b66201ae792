"""Run a function on several CPU ranks of one ``torch.distributed`` group.

The counterpart of the JAX package's virtual CPU devices
(``__graft_entry__._provision_virtual_cpu``): where JAX fakes a mesh of
devices inside one process, the port's ranks are processes.
:func:`run_ranks` spawns them, joins them into one group on a ``file://``
store in a temporary directory (no network), runs ``fn(rank, world)`` in
each and returns the results in rank order.  It is for tests and
rehearsals on the host; a rank that hangs or dies makes the call raise
within ``timeout`` seconds.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist


def _rank_main(fn, rank, world, backend, init_file, timeout, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            value = fn(rank, world)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str = "gloo", timeout: float = 120):
    """``[fn(0, world), ..., fn(world - 1, world)]``, each run in its own
    spawned process, all in one default group of ``world`` ranks.

    ``fn`` must be picklable (a module-level function) and should return
    plain Python or numpy values.  Each process runs with one thread.
    Raises ``RuntimeError`` with the traceback if a rank raises or dies,
    and ``TimeoutError`` if the ranks have not all returned within
    ``timeout`` seconds (process start included); every process is
    stopped before the call returns.
    """
    if world < 1:
        raise ValueError(f"world={world} must be >= 1")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, os.path.join(tmp, "store"), timeout,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done, deadline = {}, time.monotonic() + timeout
        try:
            while len(done) < world:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        missing = sorted(set(range(world)) - set(done))
                        raise TimeoutError(f"ranks {missing} did not return within "
                                           f"{timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} raised:\n{value}")
                done[rank] = value
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    return [done[r] for r in range(world)]

"""Sharded rollouts and endpoint metrics over the ranks of a device mesh.

Counterpart of ``bluerov2_dynamics_tpu/parallel/sharded.py``.  Every rank
holds the whole input trajectory (replicated) and runs one contiguous
block of the batch of starts; a ``dist.all_reduce`` on the group of the
``data_axis`` sums the squared errors.  Results are the same value on every
rank, as a JAX result is one global array.

* :func:`sharded_endpoint_rmse` and :func:`sharded_rollout_final` are the
  twins of the JAX package's GSPMD functions: blocks may be uneven, split
  as ``torch.tensor_split`` splits.
* :func:`shardmap_endpoint_rmse` is the twin of the explicit ``shard_map``
  form: ``n_start`` must divide by the axis size.
* :func:`shardmap_window_rmse` (K7) and its wrappers
  ``shardmap_endpoint_rmse_cuda`` / ``_wrench`` / ``_quat`` replace the
  JAX package's ``_shardmap_window_rmse`` with the Pallas window kernels
  as the per-shard body.  Each rank runs the port's single-device window
  evaluator (K2, K4 or K5) on views of its block of the replicated
  recording; the views need no copy and no pre-shifted input.  CPU tensors
  take the plain versions, CUDA tensors the kernels (or raise).

The JAX package's sharded Koopman, streaming-statistics and filter-bank
functions come with the modules they call.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bluerov2_dynamics_tpu_torch.ops.cuda_eval import (
    make_endpoint_final_cuda,
    make_endpoint_final_cuda_wrench,
)
from bluerov2_dynamics_tpu_torch.ops.cuda_quat import make_endpoint_final_cuda_quat
from bluerov2_dynamics_tpu_torch.parallel.mesh import axis


def _nan(X):
    """The single-device evaluators' NaN for ``n_start <= 0`` (float32, as
    the JAX package returns it)."""
    return torch.tensor(float("nan"), dtype=torch.float32, device=X.device)


def _sliding_scan(step: Callable, x0_batch, U, H: int, n_start: int, offset: int = 0):
    """H steps of the batch ``x0_batch`` of starts ``offset + k``; start k
    reads ``U[offset + k + t]`` at step t."""
    carry = x0_batch
    for t in range(H):
        carry = step(carry, U[t + offset:t + offset + n_start])
    return carry


def _block(n: int, size: int, index: int):
    """``[lo, hi)`` of block ``index`` of ``range(n)`` under
    ``torch.tensor_split`` into ``size`` blocks."""
    q, rem = divmod(n, size)
    lo = index * q + min(index, rem)
    return lo, lo + q + (1 if index < rem else 0)


def sharded_rollout_final(mesh: DeviceMesh, step: Callable, x0_batch, U, T: int,
                          data_axis: str = "data"):
    """Advance a ``(B, n)`` batch T steps under the shared inputs ``U (T,
    r)``, the batch split over the ``data_axis`` ranks; returns the whole
    final ``(B, n)`` batch on every rank.  Uneven blocks are padded to the
    longest for the ``all_gather`` and trimmed after it."""
    if U.shape[0] != T:
        raise ValueError(f"U has {U.shape[0]} rows for T={T} steps")
    group, size, index = axis(mesh, data_axis)
    blocks = torch.tensor_split(x0_batch, size)
    x = blocks[index]
    for t in range(T):
        x = step(x, U[t])
    padded = x.new_zeros((blocks[0].shape[0], *x.shape[1:]))
    padded[:x.shape[0]] = x
    gathered = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(gathered, padded, group=group)
    return torch.cat([g[:b.shape[0]] for g, b in zip(gathered, blocks)])


def sharded_endpoint_rmse(mesh: DeviceMesh, step: Callable, X, U, H: int,
                          data_axis: str = "data"):
    """Endpoint H-step RMSE with the batch of ``N - H`` starts split over
    the ``data_axis`` ranks, unevenly where it does not divide; the
    squared-error sum and the element count are all-reduced.  Same
    semantics as ``eval.metrics.endpoint_rmse``; ``n_start <= 0`` gives
    NaN."""
    n_start = X.shape[0] - H
    if n_start <= 0:
        return _nan(X)
    group, size, index = axis(mesh, data_axis)
    lo, hi = _block(n_start, size, index)
    final = _sliding_scan(step, X[lo:hi], U, H, hi - lo, offset=lo)
    d = final - X[H + lo:H + hi]
    total = torch.stack([torch.sum(d * d), torch.tensor(d.numel(), dtype=d.dtype,
                                                        device=d.device)])
    dist.all_reduce(total, group=group)
    return torch.sqrt(total[0] / total[1])


def _check_divisible(n_start: int, size: int) -> int:
    if n_start % size != 0:
        raise ValueError(f"n_start={n_start} not divisible by mesh axis {size}")
    return n_start // size


def shardmap_endpoint_rmse(mesh: DeviceMesh, step: Callable, X, U, H: int,
                           data_axis: str = "data"):
    """The explicit form of :func:`sharded_endpoint_rmse`: requires
    ``(N - H) % size == 0``; rank r rolls starts ``[r m, (r + 1) m)`` on
    the replicated inputs at its offset, and the squared-error sums are
    all-reduced."""
    N, n = X.shape
    n_start = N - H
    if n_start <= 0:
        return _nan(X)
    group, size, index = axis(mesh, data_axis)
    m = _check_divisible(n_start, size)
    lo = index * m
    final = _sliding_scan(step, X[lo:lo + m], U, H, m, offset=lo)
    d = final - X[H + lo:H + lo + m]
    sq = torch.sum(d * d)
    dist.all_reduce(sq, group=group)
    return torch.sqrt(sq / (n_start * n))


def window_block_sq(final_fn: Callable, X, U, H: int, start: int, m: int):
    """The per-rank body of K7: the float32 sum of squared endpoint errors
    of starts ``[start, start + m)``.  ``final_fn`` is a single-device
    window evaluator (``make_endpoint_final_cuda*``), run on the views
    ``X[start : start + m + H]`` and ``U[start : start + m + H]``; views
    of contiguous inputs keep the row alignment the kernels check."""
    final = final_fn(X[start:start + m + H], U[start:start + m + H])
    d = final - X[H + start:H + start + m].to(torch.float32)
    return torch.sum(d * d)


def shardmap_window_rmse(mesh: DeviceMesh, final_fn: Callable, X, U, H: int,
                         data_axis: str = "data"):
    """K7, the composition the three sharded window evaluators share (the
    JAX package's ``_shardmap_window_rmse``): rank r of S runs the
    single-device evaluator ``final_fn`` on starts ``[r m, (r + 1) m)``,
    ``m = n_start / S``, and the squared-error sums are all-reduced; the
    result is ``sqrt(total / (n_start n))``.  Requires ``n_start % S ==
    0``.  The wrappers below build ``final_fn`` on every call, which reads
    the coefficients back to the host; a caller that evaluates often builds
    it once (``make_endpoint_final_cuda*``) and calls this."""
    N, n = X.shape
    n_start = N - H
    if n_start <= 0:
        return _nan(X)
    group, size, index = axis(mesh, data_axis)
    m = _check_divisible(n_start, size)
    sq = window_block_sq(final_fn, X, U, H, index * m, m)
    dist.all_reduce(sq, group=group)
    return torch.sqrt(sq / (n_start * n))


def shardmap_endpoint_rmse_cuda(mesh: DeviceMesh, p, cfg, lag, X, U, dt: float, H: int,
                                method: str = "rk4", use_lag: bool = True,
                                data_axis: str = "data"):
    """Sharded endpoint RMSE of the thruster-input euler12 model, ``X (N,
    12)``, ``U (N, 8)``, with K2 (``make_endpoint_final_cuda``) as the
    per-rank body.  The JAX twin's ``block_b`` and ``interpret`` have no
    meaning here: one CUDA thread runs one start, and CPU tensors take the
    plain version."""
    fn = make_endpoint_final_cuda(p, cfg, lag, dt, H, method, use_lag)
    return shardmap_window_rmse(mesh, fn, X, U, H, data_axis)


def shardmap_endpoint_rmse_cuda_wrench(mesh: DeviceMesh, p, X, TAU, dt: float, H: int,
                                       method: str = "rk4", data_axis: str = "data"):
    """Sharded endpoint RMSE of the wrench-input euler12 model (the T3
    physics baseline), ``X (N, 12)``, ``TAU (N, 6)``, with K4 as the
    per-rank body.  No ``block_b`` or ``interpret``, as above."""
    fn = make_endpoint_final_cuda_wrench(p, dt, H, method)
    return shardmap_window_rmse(mesh, fn, X, TAU, H, data_axis)


def shardmap_endpoint_rmse_cuda_quat(mesh: DeviceMesh, p, X, TAU, dt: float, H: int,
                                     method: str = "euler", renormalize: bool = True,
                                     data_axis: str = "data"):
    """Sharded endpoint RMSE of the quat13 wrench-input model (the T4
    physics baseline), ``X (N, 13)``, ``TAU (N, 6)``, with K5 as the
    per-rank body.  No ``block_b`` or ``interpret``, as above."""
    fn = make_endpoint_final_cuda_quat(p, dt, H, method, renormalize)
    return shardmap_window_rmse(mesh, fn, X, TAU, H, data_axis)

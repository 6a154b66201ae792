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
  as the per-shard body.  Each rank runs the fused form of the port's
  single-device window evaluator (K2, K4 or K5,
  ``make_endpoint_sq_cuda*``) on views of its block of the replicated
  recording: one launch returns the block's squared-error sum, then a
  one-element all-reduce and a sqrt.  The views need no copy and no
  pre-shifted input.  CPU tensors take the plain versions, CUDA tensors
  the kernels (or raise).  :func:`window_block_sq` keeps the unfused body
  (endpoints, then ``torch.sum``) for the card checks.

The sharded Koopman functions (:func:`sharded_koopman_multistep_rmse`,
:func:`sharded_koopman_fit`, :func:`sharded_streaming_stats`) are the JAX
package's, with the collectives XLA would insert written out: an
all-gather of the lifted state's column blocks, and all-reduces of Gram,
right-hand side and squared-error sums.

The filter banks (:func:`sharded_ekf_bank`, :func:`sharded_pf_bank`) are
the JAX package's GSPMD-sharded ``vmap`` of a filter: each rank filters
its contiguous block of trajectories (blocks as ``torch.tensor_split``
makes them) and an all-gather assembles the bank's result on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bluerov2_dynamics_tpu_torch.ops.cuda_eval import (
    endpoint_sq,
    make_endpoint_sq_cuda,
    make_endpoint_sq_cuda_wrench,
)
from bluerov2_dynamics_tpu_torch.models import koopman
from bluerov2_dynamics_tpu_torch.models.estimation import (
    FilterResult,
    ParticleFilterResult,
    _check_inputs,
    ekf,
    particle_filter_bank,
)
from bluerov2_dynamics_tpu_torch.ops.cuda_quat import make_endpoint_sq_cuda_quat
from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.parallel.mesh import axis, replicate


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
    """The unfused per-rank body of K7: the float32 sum of squared endpoint
    errors of starts ``[start, start + m)``, as a single-device window
    evaluator ``final_fn`` (``make_endpoint_final_cuda*``) on the views
    ``X[start : start + m + H]`` and ``U[start : start + m + H]``, then
    ``torch.sum``.  Views of contiguous inputs keep the row alignment the
    kernels check."""
    Xb = X[start:start + m + H]
    return endpoint_sq(final_fn(Xb, U[start:start + m + H]), Xb, H)


def shardmap_window_rmse(mesh: DeviceMesh, sq_fn: Callable, X, U, H: int,
                         data_axis: str = "data"):
    """K7, the composition the three sharded window evaluators share (the
    JAX package's ``_shardmap_window_rmse``): rank r of S runs the fused
    single-device evaluator ``sq_fn`` (``make_endpoint_sq_cuda*``: one
    launch) on the views of its starts ``[r m, (r + 1) m)``, ``m = n_start /
    S``, the one-element sums are all-reduced, and the result is
    ``sqrt(total / (n_start n))``.  Requires ``n_start % S == 0``.  The
    wrappers below build ``sq_fn`` on every call, which reads the
    coefficients back to the host in one copy; a caller that evaluates
    often builds it once and calls this."""
    N, n = X.shape
    n_start = N - H
    if n_start <= 0:
        return _nan(X)
    group, size, index = axis(mesh, data_axis)
    m = _check_divisible(n_start, size)
    lo = index * m
    sq = sq_fn(X[lo:lo + m + H], U[lo:lo + m + H])
    dist.all_reduce(sq, group=group)
    return torch.sqrt(sq / (n_start * n))


def shardmap_endpoint_rmse_cuda(mesh: DeviceMesh, p, cfg, lag, X, U, dt: float, H: int,
                                method: str = "rk4", use_lag: bool = True,
                                data_axis: str = "data"):
    """Sharded endpoint RMSE of the thruster-input euler12 model, ``X (N,
    12)``, ``U (N, 8)``, with K2 fused (``make_endpoint_sq_cuda``) as the
    per-rank body.  The JAX twin's ``block_b`` and ``interpret`` have no
    meaning here: the kernel's launch plan is its own, and CPU tensors take
    the plain version."""
    fn = make_endpoint_sq_cuda(p, cfg, lag, dt, H, method, use_lag)
    return shardmap_window_rmse(mesh, fn, X, U, H, data_axis)


def shardmap_endpoint_rmse_cuda_wrench(mesh: DeviceMesh, p, X, TAU, dt: float, H: int,
                                       method: str = "rk4", data_axis: str = "data"):
    """Sharded endpoint RMSE of the wrench-input euler12 model (the T3
    physics baseline), ``X (N, 12)``, ``TAU (N, 6)``, with K4 fused as the
    per-rank body.  No ``block_b`` or ``interpret``, as above."""
    fn = make_endpoint_sq_cuda_wrench(p, dt, H, method)
    return shardmap_window_rmse(mesh, fn, X, TAU, H, data_axis)


def shardmap_endpoint_rmse_cuda_quat(mesh: DeviceMesh, p, X, TAU, dt: float, H: int,
                                     method: str = "euler", renormalize: bool = True,
                                     data_axis: str = "data"):
    """Sharded endpoint RMSE of the quat13 wrench-input model (the T4
    physics baseline), ``X (N, 13)``, ``TAU (N, 6)``, with K5 fused as the
    per-rank body.  No ``block_b`` or ``interpret``, as above."""
    fn = make_endpoint_sq_cuda_quat(p, dt, H, method, renormalize)
    return shardmap_window_rmse(mesh, fn, X, TAU, H, data_axis)


# --- Koopman --------------------------------------------------------------------

def _gather_columns(block, widths, group):
    """The whole ``(m, sum(widths))`` matrix from each rank's column block
    (``widths[i]`` columns on rank i of ``group``), padded for the
    all-gather and trimmed after it."""
    padded = block.new_zeros((block.shape[0], max(widths)))
    padded[:, :block.shape[1]] = block
    parts = [torch.empty_like(padded) for _ in widths]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:, :w] for p, w in zip(parts, widths)], dim=1)


@full_f32()
def sharded_koopman_multistep_rmse(mesh: DeviceMesh, model, X, U, H: int,
                                   data_axis: str = "data", model_axis: str = "model",
                                   method: str = "scan"):
    """Endpoint H-step Koopman RMSE over all N-H starts, on a 2-D mesh:
    the starts split over ``data_axis``, the rows of the ``(d, d)``
    operator ``A`` (the lifted state's columns) over ``model_axis``.

    Each rank holds the replicated model and computes its column block of
    the propagated lifted state for its block of starts.  ``"scan"``
    all-gathers the blocks over ``model_axis`` after every step (one
    all-gather a step); ``"conv"`` computes its block of the endpoint as
    one control-convolution GEMM and all-gathers once.  The squared errors
    and counts are all-reduced over ``data_axis``.  Same semantics as
    ``models.koopman.multistep_rmse``; ``N <= H`` gives NaN.
    """
    if method not in ("scan", "conv"):
        raise ValueError(f"method must be 'scan' or 'conv', got {method!r}")
    n_start = X.shape[0] - H
    if n_start <= 0:
        return _nan(X)
    dgroup, dsize, didx = axis(mesh, data_axis)
    mgroup, msize, midx = axis(mesh, model_axis)
    lo, hi = _block(n_start, dsize, didx)
    d = model.lift_dim
    widths = [b - a for a, b in (_block(d, msize, i) for i in range(msize))]
    c0, c1 = _block(d, msize, midx)
    A_T, B_T = model.A.T, model.B.T
    Z = koopman.lift(model, X[lo:hi])
    if H > 0 and method == "conv":
        Z = _gather_columns(koopman._endpoint_conv(Z, U[lo:], A_T, B_T, H, hi - lo,
                                                   cols=slice(c0, c1)), widths, mgroup)
    else:
        for t in range(H):
            Z = _gather_columns(Z @ A_T[:, c0:c1] + U[lo + t:hi + t] @ B_T[:, c0:c1],
                                widths, mgroup)
    diff = koopman.decode(model, Z) - X[H + lo:H + hi]
    total = torch.stack([torch.sum(diff * diff),
                         torch.tensor(diff.numel(), dtype=diff.dtype, device=diff.device)])
    dist.all_reduce(total, group=dgroup)
    return torch.sqrt(total[0] / total[1])


@full_f32()
def sharded_koopman_fit(mesh: DeviceMesh, generator, X, U, n_rbfs: int = 200,
                        gamma: float = 1.0, ridge: float = 1e-8, kmeans_iters: int = 25,
                        data_axis: str = "data", position_invariant: bool = False,
                        fit_decoder: bool = False, decoder_ridge: float = 1e-6, init=None):
    """Koopman EDMDc fit with the snapshot pairs split over ``data_axis``.

    k-means runs on every rank and the first rank's centers are broadcast,
    so all ranks lift with the same dictionary.  Each rank forms the float64
    Gram ``G^T G`` and cross term ``G^T Y`` of its contiguous block of pairs
    (``models.koopman._gram``); an
    all-reduce sums them and the small ``(d+r)^2`` solve is replicated.
    ``position_invariant`` and ``fit_decoder`` (relative ``decoder_ridge``,
    the decoder's Gram summed the same way over row blocks of ``X``) as in
    ``models.koopman.fit`` and ``fit_decoder``.
    """
    group, size, index = axis(mesh, data_axis)
    weights = koopman._position_mask(X) if position_invariant else None
    X_cl = X * weights if weights is not None else X
    centers, _ = kmeans(X_cl, n_rbfs, kmeans_iters, generator, init)
    centers = replicate(mesh, centers)
    gamma = torch.as_tensor(gamma, dtype=X.dtype, device=X.device)
    lo, hi = _block(X.shape[0] - 1, size, index)
    Z = rbf_lift(X[lo:hi], centers, gamma, weights)
    Zp = rbf_lift(X[lo + 1:hi + 1], centers, gamma, weights)
    gram, rhs = koopman._gram(torch.cat([Z, U[lo:hi]], dim=1), Zp)
    dist.all_reduce(gram, group=group)
    dist.all_reduce(rhs, group=group)
    M = koopman._solve_normal_eqns(gram, rhs, ridge).to(X.dtype)
    d = Z.shape[1]
    decoder = None
    if fit_decoder:
        lo, hi = _block(X.shape[0], size, index)
        gram_d, rhs_d = koopman._gram(rbf_lift(X[lo:hi], centers, gamma, weights), X[lo:hi])
        dist.all_reduce(gram_d, group=group)
        dist.all_reduce(rhs_d, group=group)
        scale = torch.mean(torch.diagonal(gram_d))
        decoder = koopman._solve_normal_eqns(gram_d, rhs_d, decoder_ridge * scale).T.to(X.dtype)
    return koopman.KoopmanModel(centers=centers, gamma=gamma, A=M[:d].T, B=M[d:].T,
                                decoder=decoder, rbf_weights=weights)


@full_f32()
def sharded_streaming_stats(mesh: DeviceMesh, stats0, X, U, chunk: int = 1024,
                            forgetting: float = 1.0, data_axis: str = "data"):
    """Accumulate Koopman streaming statistics with the recording split
    over ``data_axis`` in contiguous blocks (the multi-rank form of
    ``models.koopman.streaming_scan``).

    Each rank runs the chunk loop over its block, its carry seeded with a
    one-row halo (its left neighbour's last row), so the pairs are the
    single-rank scan's.  With ``forgetting < 1`` each rank's statistics are
    decayed by ``lam^(pairs downstream of it)`` before the all-reduce, so
    the sum equals the sequential scan up to summation order.  ``stats0``
    may carry earlier data: its ``prev_*`` seed rank 0 and its Gram decays
    by ``lam^M``, M the pairs added here.  ``X.shape[0]`` must divide by the
    axis size.
    """
    N = X.shape[0]
    group, S, idx = axis(mesh, data_axis)
    if N % S != 0:
        raise ValueError(f"N={N} not divisible by mesh axis {S}")
    m = N // S
    dtype, device = stats0.gram.dtype, stats0.gram.device
    X = torch.as_tensor(X, dtype=dtype, device=device)
    U = torch.as_tensor(U, dtype=dtype, device=device)
    lam = torch.as_tensor(forgetting, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    if idx == 0:
        prev = (stats0.prev_z, stats0.prev_u, stats0.prev_valid)
    else:
        halo = X[idx * m - 1:idx * m]
        prev = (rbf_lift(halo, stats0.centers, stats0.gamma, stats0.rbf_weights)[0],
                U[idx * m - 1], one)
    s = stats0._replace(gram=torch.zeros_like(stats0.gram), rhs=torch.zeros_like(stats0.rhs),
                        weight_sum=torch.zeros_like(stats0.weight_sum), prev_z=prev[0],
                        prev_u=prev[1], prev_valid=prev[2])
    s = koopman.streaming_scan(s, X[idx * m:(idx + 1) * m], U[idx * m:(idx + 1) * m], chunk, lam)
    decay = lam ** float((S - 1 - idx) * m)        # every rank downstream adds m pairs
    gram, rhs, wsum = s.gram * decay, s.rhs * decay, s.weight_sum * decay
    for t in (gram, rhs, wsum):
        dist.all_reduce(t, group=group)
    carry_decay = lam ** ((N - 1) + stats0.prev_valid)
    return stats0._replace(
        gram=carry_decay * stats0.gram + gram,
        rhs=carry_decay * stats0.rhs + rhs,
        weight_sum=carry_decay * stats0.weight_sum + wsum,
        prev_z=rbf_lift(X[-1:], stats0.centers, stats0.gamma, stats0.rbf_weights)[0],
        prev_u=U[-1],
        prev_valid=one,
    )


# --- filter banks -----------------------------------------------------------------

def _gather_rows(block, sizes, group):
    """The whole ``(sum(sizes), ...)`` tensor from each rank's row block
    (``sizes[i]`` rows on rank i of ``group``), padded for the all-gather
    and trimmed after it."""
    padded = block.new_zeros((max(sizes), *block.shape[1:]))
    padded[:block.shape[0]] = block
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded.contiguous(), group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def _bank_block(mesh: DeviceMesh, data_axis: str, U, Y):
    _check_inputs(U, Y, 1)
    group, size, index = axis(mesh, data_axis)
    B = Y.shape[0]
    sizes = [hi - lo for lo, hi in (_block(B, size, i) for i in range(size))]
    return group, sizes, _block(B, size, index)


def sharded_ekf_bank(mesh: DeviceMesh, step: Callable, h: Callable, Q, R, m0, P0, U, Y,
                     data_axis: str = "data", residual: Callable = None):
    """Bank of independent EKFs, one per trajectory, sharded over
    ``data_axis``: ``U`` ``(B, T-1, r)``, ``Y`` ``(B, T, m)``, ``m0``
    ``(B, n)``; ``Q``/``R``/``P0`` shared.  Each rank runs the bank of its
    block (``estimation.ekf(..., batched=True)``); the result, a
    ``FilterResult`` with a leading bank axis, is the whole bank's on
    every rank."""
    group, sizes, (lo, hi) = _bank_block(mesh, data_axis, U, Y)
    res = ekf(step, h, Q, R, m0[lo:hi], P0, U[lo:hi], Y[lo:hi], residual=residual,
              batched=True)
    return FilterResult(*(_gather_rows(t, sizes, group) for t in res))


def sharded_pf_bank(mesh: DeviceMesh, step: Callable, h: Callable, Q, R, m0, P0, U, Y,
                    seed: int = 0, n_particles: int = 1024, data_axis: str = "data",
                    ess_frac: float = 0.5, residual: Callable = None):
    """Bank of bootstrap particle filters, one per trajectory, sharded as
    :func:`sharded_ekf_bank`.  Trajectory ``b`` draws from its own stream
    ``estimation.pf_stream(seed, device, b)`` (the JAX package's
    ``fold_in(key, b)``), so its filter does not depend on how the bank is
    split over the ranks."""
    group, sizes, (lo, hi) = _bank_block(mesh, data_axis, U, Y)
    res = particle_filter_bank(step, h, Q, R, m0[lo:hi], P0, U[lo:hi], Y[lo:hi],
                               n_particles=n_particles, seed=seed, ess_frac=ess_frac,
                               residual=residual, indices=range(lo, hi))
    return ParticleFilterResult(*(_gather_rows(t, sizes, group) for t in res))

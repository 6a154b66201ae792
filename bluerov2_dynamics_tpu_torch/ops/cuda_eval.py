"""K2, K3 and K4: the euler12 sliding-window evaluators and the
per-trajectory rollout, as CUDA kernels and their plain PyTorch versions.

* K2 replaces ``ops/pallas_eval.py::_make_thruster_window_kernel`` of the
  JAX package (reached through ``make_endpoint_final_pallas``).  For every
  start ``s < N - H``: H steps from ``X[s]`` under the commands
  ``U[s + t]``, each step being the T200 curve, the (3, 8) lag (zero at
  every start), the wrench map and one Euler/RK4 step; the ``(N - H, 12)``
  endpoints feed the endpoint RMSE.
* K3 replaces ``make_batched_rollout_pallas``: K2's body with one command
  sequence per trajectory, ``x0 (B, 12)``, ``U (T, B, 8)`` -> ``(B, 12)``,
  each trajectory from a fresh zero lag state.
* K4 replaces ``_make_wrench_window_kernel`` (reached through
  ``make_endpoint_final_pallas_wrench``): the sliding window of the
  wrench-input euler12 model, ``X (N, 12)``, ``TAU (N, 6)``, with no curve
  and no lag (the T3 app's physics baseline).

K2 and K4 have a fused form (``make_endpoint_sq_cuda*``): the kernel itself
reduces ``sum over s of |x_H(s) - X[s + H]|^2`` to one float32, so an
evaluator call is one launch and a sqrt, and K7's per-rank body
(``parallel/sharded.py``) is one launch before its all-reduce.  Its plain
version (``window_sq_plain*``) is the endpoints, then ``torch.sum(d * d)``
in float32, the JAX package's per-shard body.

``csrc/window_eval.cu`` holds K2 and K4.  K2 runs one thread per start
(:func:`window_plan`; splitting a start over lanes of a warp measured
slower), the state and lag in registers, inputs read directly
(neighbouring starts read neighbouring rows; no pre-shifted copy of the
input).  K4 splits a start's row step over a pair of warps up to a
threshold of starts an SM, and above it runs one thread a start with each
block's wrench rows staged in shared memory (:func:`wrench_plan`,
``csrc/window_rows.cuh``).  ``csrc/batched_rollout.cu`` holds K3: one
thread per trajectory, each step's commands loaded into registers one
step ahead (:func:`stage_plan`).  The plain versions run all starts at once as
``(n_start,)`` rows with the same step order and association as the
kernels.

The wrappers dispatch on the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ThrusterConfig,
)
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops.cuda_rollout import (
    METHODS,
    RowConsts,
    ThrusterConsts,
    check_kernel_input,
    check_method,
    host_float_groups,
    make_rhs_rows,
    rk4_rows,
    row_consts,
    same_device,
    thruster_consts,
)
from bluerov2_dynamics_tpu_torch.utils.profiling import span


def check_window_shapes(X, U, H: int, n_state: int = 12, n_in: int = 8) -> int:
    """Validate ``X (N, n_state)``, ``U (>= N, n_in)`` and ``0 <= H < N``;
    returns the number of starts ``N - H``.  A too-wide ``U`` would be
    misread and a too-short one would integrate past its end, so both
    raise."""
    if X.ndim != 2 or X.shape[1] != n_state:
        raise ValueError(f"X must be (N, {n_state}), got {tuple(X.shape)}")
    if U.ndim != 2 or U.shape[1] != n_in:
        raise ValueError(f"U must be (N, {n_in}), got {tuple(U.shape)}")
    N = X.shape[0]
    if U.shape[0] < N:
        raise ValueError(f"U has {U.shape[0]} rows < X's {N}; every window "
                         f"start needs H={H} inputs")
    if H < 0 or N - H <= 0:
        raise ValueError(f"horizon H={H} outside [0, {N}) for a dataset of {N} rows")
    return N - H


def check_aligned(t, name: str, nbytes: int) -> None:
    """The kernels load input rows as ``float4`` or ``float2``."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned (the kernel loads "
                         f"its rows {nbytes} bytes at a time)")


def _wrench_rows(Wm, F):
    """``tau_i = sum_j Wm[j][i] F_j`` in ascending ``j``, zeros skipped."""
    tau = []
    for i in range(6):
        acc = 0
        for j in range(8):
            if Wm[j][i] != 0.0:
                acc = acc + Wm[j][i] * F[j]
        tau.append(acc)
    return tuple(tau)


def _thruster_rows_plain(p: FossenParams, cfg: ThrusterConfig, lag: LagParams,
                        x0, inputs, T: int, dt: float, method: str, use_lag: bool):
    """The body of K2 and K3: the rows ``x0 (B, 12)`` advance T steps
    under the commands ``inputs(t) (B, 8)``, from a fresh zero lag."""
    rhs = make_rhs_rows(p)
    (c1, c3, c5, c7, c9), W, A, Bd, cl = host_float_groups(cfg.curve, cfg.wrench_map, lag.Ad,
                                                          lag.Bd, lag.c)
    Wm = [W[6 * j:6 * j + 6] for j in range(8)]
    Ad = [A[0:3], A[3:6], A[6:9]]

    xs = tuple(x0.to(torch.float32).unbind(-1))
    L0 = L1 = L2 = torch.zeros((x0.shape[0], 8), dtype=torch.float32, device=x0.device)
    for t in range(T):
        u = inputs(t)                              # (B, 8)
        u2 = u * u
        F_cmd = u * (c1 + u2 * (c3 + u2 * (c5 + u2 * (c7 + u2 * c9))))
        if use_lag:
            N0 = Ad[0][0] * L0 + Ad[0][1] * L1 + Ad[0][2] * L2 + Bd[0] * F_cmd
            N1 = Ad[1][0] * L0 + Ad[1][1] * L1 + Ad[1][2] * L2 + Bd[1] * F_cmd
            N2 = Ad[2][0] * L0 + Ad[2][1] * L1 + Ad[2][2] * L2 + Bd[2] * F_cmd
            F = cl[0] * N0 + cl[1] * N1 + cl[2] * N2
            L0, L1, L2 = N0, N1, N2
        else:
            F = F_cmd
        tau = _wrench_rows(Wm, F.unbind(-1))
        xs = rk4_rows(rhs, xs, tau, dt, method)
    return torch.stack(xs, dim=-1)


def endpoint_final_plain(p: FossenParams, cfg: ThrusterConfig, lag: LagParams,
                         X, U, dt: float, H: int, method: str = "rk4",
                         use_lag: bool = True):
    """Plain PyTorch version of K2: ``(N - H, 12)`` endpoint states of all
    sliding-window rollouts, each from a fresh zero lag state."""
    check_method(method)
    n_start = check_window_shapes(X, U, H)
    Uf = U.to(torch.float32)
    return _thruster_rows_plain(p, cfg, lag, X[:n_start], lambda t: Uf[t:t + n_start],
                                H, dt, method, use_lag)


def check_batched_shapes(x0, U) -> None:
    """Validate ``x0 (B, 12)`` and ``U (T, B, 8)``."""
    if x0.ndim != 2 or x0.shape[1] != 12:
        raise ValueError(f"x0 must be (B, 12), got {tuple(x0.shape)}")
    if U.ndim != 3 or U.shape[1:] != (x0.shape[0], 8):
        raise ValueError(f"U must be (T, B, 8) with B={x0.shape[0]}, got {tuple(U.shape)}")


def batched_rollout_plain(p: FossenParams, cfg: ThrusterConfig, lag: LagParams,
                          x0, U, dt: float, method: str = "rk4", use_lag: bool = True):
    """Plain PyTorch version of K3: ``x0 (B, 12)`` under its own commands
    ``U (T, B, 8)``, each from a fresh zero lag state -> ``(B, 12)``."""
    check_method(method)
    check_batched_shapes(x0, U)
    Uf = U.to(torch.float32)
    return _thruster_rows_plain(p, cfg, lag, x0, lambda t: Uf[t], U.shape[0], dt,
                                method, use_lag)


def endpoint_final_wrench_plain(p: FossenParams, X, TAU, dt: float, H: int,
                                method: str = "rk4"):
    """Plain PyTorch version of K4: ``(N - H, 12)`` endpoint states of the
    wrench-input euler12 model under ``TAU (N, 6)``."""
    check_method(method)
    n_start = check_window_shapes(X, TAU, H, n_in=6)
    rhs = make_rhs_rows(p)
    xs = tuple(X[:n_start].to(torch.float32).unbind(-1))
    Tf = TAU.to(torch.float32)
    for t in range(H):
        xs = rk4_rows(rhs, xs, tuple(Tf[t:t + n_start].unbind(-1)), dt, method)
    return torch.stack(xs, dim=-1)


# Threads a block of the window kernels: csrc/window_eval.cu's kThreads (K2,
# K4) and csrc/quat.cu's kWindowThreads (K5).
WINDOW_THREADS = 64


def window_plan(n_start: int, H: int) -> dict:
    """The window kernels' launch plan for ``n_start`` starts of ``H``
    steps: one thread a start (``lanes``), block size and grid.  In the
    fused form the threads of the last block past the end shadow the last
    start and add nothing."""
    return dict(lanes=1, block=WINDOW_THREADS, n_blocks=-(-n_start // WINDOW_THREADS),
                n_steps=H)


@dataclass(frozen=True)
class WindowConsts:
    """The launch constants of a wrench-input window kernel (K4 in
    ``csrc/window_eval.cu``, K5 in ``csrc/quat.cu``), named as there."""

    threads: int                 # kThreads / kWindowThreads: the one-thread form's block
    tau_chunk: int               # kWrenchTauChunk / kWindowTauChunk: steps of TAU staged at a time
    pairs: int = 0               # kWrenchPairs: warp pairs a block of the pair form (0: none)
    split_starts_per_sm: int = 0  # kWrenchSplitStartsPerSm: the most starts an SM on a pair

    def split_threshold(self, sms: int) -> int:
        """The most starts for which the plan puts a start on a warp pair."""
        return self.split_starts_per_sm * sms if self.pairs else 0


# csrc/window_eval.cu's K4 constants (by measurement, PERF.md)
WRENCH_CONSTS = WindowConsts(threads=WINDOW_THREADS, tau_chunk=128, pairs=2,
                             split_starts_per_sm=192)
EXCHANGE_BYTES = 2 * 4 * 32 * 16   # a pair's buffers: 2 parities x 4 float4s x 32 lanes
TAU_ROW_BYTES = 24                  # one row of TAU, 6 float32


def split_plan(c: WindowConsts, n_start: int, H: int, sms: int) -> dict:
    """The launch plan of a wrench-input window kernel for ``n_start``
    starts of ``H`` steps on a card of ``sms`` SMs: warps a start (2 up to
    ``c.split_threshold(sms)`` starts, else 1), starts a block, block
    size, grid, and the static shared bytes of its endpoint form (the
    fused form adds ``grid_sum``'s few words).  In the pair form lane
    ``l`` of both warps of pair ``j`` of block ``b`` runs start ``(b *
    pairs + j) * 32 + l``; in the one-thread form, which stages the
    block's TAU rows, thread ``t`` of block ``b`` runs start ``b *
    threads + t``.  Lanes past the end shadow the last start and write and
    add nothing."""
    if n_start <= c.split_threshold(sms):
        warps, spb, shared = 2, 32 * c.pairs, c.pairs * EXCHANGE_BYTES
    else:
        warps, spb = 1, c.threads
        shared = (c.threads + c.tau_chunk - 1) * TAU_ROW_BYTES
    return dict(warps=warps, starts_per_block=spb, block=warps * spb,
                n_blocks=-(-n_start // spb), shared_bytes=shared, n_steps=H)


def wrench_plan(n_start: int, H: int, sms: int) -> dict:
    """K4's launch plan (:func:`split_plan` of ``WRENCH_CONSTS``)."""
    return split_plan(WRENCH_CONSTS, n_start, H, sms)


def sm_count(device) -> int:
    """The SMs of the CUDA ``device``, as the kernels' launchers read them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_window_eval(rc: RowConsts, tc: ThrusterConsts, X, U, H: int,
                       method: str, use_lag: bool):
    """Launch K2; returns the ``(N - H, 12)`` endpoints."""
    check_method(method)
    n_start = check_window_shapes(X, U, H)
    _check_thruster_window(X, U)
    lib = _build.load_library("window_eval")
    out = torch.empty((n_start, 12), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        code = lib.brov2_window_eval(
            ctypes.addressof(rc), ctypes.addressof(tc), X.data_ptr(), U.data_ptr(),
            out.data_ptr(), n_start, H, METHODS[method], int(use_lag),
            torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(lib, code, "window_eval")
    _build.launches["window_eval"] += 1
    return out


def _check_thruster_window(X, U) -> None:
    """Raise on what K2 does not take."""
    check_kernel_input(X, "X", 12)
    check_kernel_input(U, "U", 8)
    if not same_device(X, U):
        raise ValueError("X and U must be on one device")
    check_aligned(U, "U", 16)


_SQ_SCRATCH: dict = {}


def sq_scratch(X, n_blocks: int):
    """``(sq, partials, ticket, stream)`` for one launch of a fused window
    kernel on the current stream of ``X``'s device: a new 0-d float32
    result; partials of at least ``n_blocks`` floats and the ticket, both
    kept per stream.  The ticket is zeroed once here; every launch's last
    block leaves it at zero, and launches on one stream run in order."""
    stream = torch.cuda.current_stream(X.device).cuda_stream
    partials, ticket = _SQ_SCRATCH.get((X.device, stream), (None, None))
    if ticket is None:
        ticket = torch.zeros((), dtype=torch.int32, device=X.device)
    if partials is None or partials.numel() < n_blocks:
        partials = torch.empty(n_blocks, dtype=torch.float32, device=X.device)
    _SQ_SCRATCH[X.device, stream] = partials, ticket
    return torch.empty((), dtype=torch.float32, device=X.device), partials, ticket, stream


def launch_window_sq(rc: RowConsts, tc: ThrusterConsts, X, U, H: int, method: str,
                     use_lag: bool):
    """Launch K2 fused; returns the 0-d float32 sum over the ``N - H``
    starts of ``|x_H(s) - X[s + H]|^2``.  The whole call, checks to
    ``_build.check``, is the span ``brov2.wrapper.launch``."""
    with span("brov2.wrapper.launch"):
        check_method(method)
        n_start = check_window_shapes(X, U, H)
        _check_thruster_window(X, U)
        lib = _build.load_library("window_eval")
        with torch.cuda.device(X.device):
            sq, partials, ticket, stream = sq_scratch(X, window_plan(n_start, H)["n_blocks"])
            code = lib.brov2_window_sq(
                ctypes.addressof(rc), ctypes.addressof(tc), X.data_ptr(), U.data_ptr(),
                sq.data_ptr(), partials.data_ptr(), partials.numel(), ticket.data_ptr(),
                n_start, H, METHODS[method], int(use_lag), stream)
        _build.check(lib, code, "window_sq")
        _build.launches["window_sq"] += 1
        return sq


def window_occupancy(method: str = "euler", use_lag: bool = True, fused: bool = False) -> dict:
    """K2's block size as the kernel launches it and the resident blocks per
    SM of its endpoint or ``fused`` instantiation (the CUDA occupancy
    query)."""
    check_method(method)
    lib = _build.load_library("window_eval")
    block, per_sm = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.brov2_window_occupancy(
        METHODS[method], int(use_lag), int(fused), ctypes.byref(block), ctypes.byref(per_sm)),
        "window_eval occupancy")
    return dict(block=block.value, blocks_per_sm=per_sm.value)


def make_endpoint_final_cuda(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    dt: float,
    H: int,
    method: str = "rk4",
    use_lag: bool = True,
):
    """Build ``fn(X, U) -> (N - H, 12)`` endpoint states for the
    thruster-input model (fresh zero lag state per start); feed into
    ``rmse(X[H:], final)`` for the metric.  The constants are read once
    here and passed at launch, so fitted coefficients need no rebuild."""
    check_method(method)
    rc, tc = row_consts(p, dt), thruster_consts(cfg, lag)

    def fn(X, U):
        if not same_device(X, U):
            raise ValueError(f"X and U on different devices ({X.device}, {U.device})")
        if X.device.type == "cpu":
            return endpoint_final_plain(p, cfg, lag, X, U, dt, H, method, use_lag)
        return launch_window_eval(rc, tc, X, U, H, method, use_lag)

    return fn


def endpoint_sq(final, X, H: int):
    """``sum |final - X[H:]|^2`` in float32: the JAX package's per-shard
    body (``parallel/sharded.py:178-179``) on the endpoints."""
    d = final - X[H:H + final.shape[0]].to(torch.float32)
    return torch.sum(d * d)


def window_sq_plain(p: FossenParams, cfg: ThrusterConfig, lag: LagParams, X, U, dt: float,
                    H: int, method: str = "rk4", use_lag: bool = True):
    """Plain PyTorch version of K2 fused: the endpoints of
    :func:`endpoint_final_plain`, then :func:`endpoint_sq`."""
    return endpoint_sq(endpoint_final_plain(p, cfg, lag, X, U, dt, H, method, use_lag), X, H)


def make_endpoint_sq_cuda(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    dt: float,
    H: int,
    method: str = "rk4",
    use_lag: bool = True,
):
    """Build ``fn(X, U) -> 0-d float32``, the sum over the ``N - H`` starts
    of ``|x_H(s) - X[s + H]|^2`` for the thruster-input model: one launch of
    K2 fused on CUDA tensors, :func:`window_sq_plain` on CPU tensors.  The
    endpoint RMSE is ``sqrt(sq / ((N - H) 12))``."""
    check_method(method)
    rc, tc = row_consts(p, dt), thruster_consts(cfg, lag)

    def fn(X, U):
        if not same_device(X, U):
            raise ValueError(f"X and U on different devices ({X.device}, {U.device})")
        if X.device.type == "cpu":
            return window_sq_plain(p, cfg, lag, X, U, dt, H, method, use_lag)
        return launch_window_sq(rc, tc, X, U, H, method, use_lag)

    return fn


def endpoint_rmse_cuda(p, cfg, lag, X, U, dt: float, H: int, **kw):
    """Endpoint H-step RMSE through :func:`make_endpoint_final_cuda`."""
    final = make_endpoint_final_cuda(p, cfg, lag, dt, H, **kw)(X, U)
    return rmse(X[H:].to(torch.float32), final)


# K3's stage plan, the constants of csrc/batched_rollout.cu (kBlock,
# kMinBlocks): a block runs BLOCK trajectories, one a thread, and each
# thread holds DEPTH rows of its commands in registers (the row of the step
# it computes and the next one's, in flight).  __launch_bounds__(BLOCK,
# MIN_BLOCKS) caps a thread at REGISTERS // (MIN_BLOCKS x BLOCK) registers.
BLOCK, MIN_BLOCKS = 256, 2        # by measurement (PERF.md)
DEPTH = 2
ROW_BYTES = 32                    # one trajectory's 8 float32 commands
REGISTERS = 65_536                # 32-bit registers an H100 SM holds


def stage_plan(B: int, T: int) -> dict:
    """K3's launch plan for ``B`` trajectories of ``T`` steps: block size,
    rows in flight a thread, grid, the register cap its launch bounds set,
    and shared bytes (none: the rows stay in registers)."""
    return dict(block=BLOCK, depth=DEPTH, n_blocks=-(-B // BLOCK), n_steps=T,
                max_registers=REGISTERS // (MIN_BLOCKS * BLOCK), shared_bytes=0)


def stage_loads(B: int, T: int):
    """The command loads K3 makes, as ``(issued_at_step, step, trajectory,
    source_offset_bytes, bytes)``, one a 16-byte half of a row: a thread
    loads its row of step 0 before the step loop, and its row of step t at
    the top of step t - 1, so each row lands while the step before it
    computes.  No load past B or T."""
    return [(max(0, t - 1), t, b, (t * B + b) * ROW_BYTES + half, 16)
            for b in range(B) for t in range(T) for half in (0, 16)]


def batched_rollout_occupancy(method: str = "rk4", use_lag: bool = True) -> tuple:
    """``(block, resident blocks per SM)`` of K3 as it launches (the CUDA
    occupancy query)."""
    check_method(method)
    lib = _build.load_library("batched_rollout")
    block, n = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.brov2_batched_rollout_occupancy(
        METHODS[method], int(use_lag), ctypes.byref(block), ctypes.byref(n)),
        "batched_rollout occupancy")
    return block.value, n.value


def launch_batched_rollout(rc: RowConsts, tc: ThrusterConsts, x0, U, method: str,
                           use_lag: bool):
    """Launch K3 on ``x0 (B, 12)`` under ``U (T, B, 8)``."""
    check_method(method)
    check_batched_shapes(x0, U)
    check_kernel_input(x0, "x0", 12)
    if not U.is_contiguous():
        raise ValueError("U must be contiguous")
    check_kernel_input(U.view(-1, 8), "U", 8)
    if not same_device(x0, U):
        raise ValueError("x0 and U must be on one device")
    check_aligned(U, "U", 16)
    out = torch.empty_like(x0)
    B, T = x0.shape[0], U.shape[0]
    if B == 0:
        return out
    lib = _build.load_library("batched_rollout")
    with torch.cuda.device(x0.device):
        code = lib.brov2_batched_rollout(
            ctypes.addressof(rc), ctypes.addressof(tc), x0.data_ptr(), U.data_ptr(),
            out.data_ptr(), B, T, METHODS[method], int(use_lag),
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(lib, code, "batched_rollout")
    _build.launches["batched_rollout"] += 1
    return out


def make_batched_rollout_cuda(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    dt: float,
    method: str = "rk4",
    use_lag: bool = True,
):
    """Build ``fn(x0, U) -> xT`` for per-trajectory commands: ``x0 (B, 12)``,
    ``U (T, B, 8)``; each trajectory starts from a fresh zero lag state.
    Any B works (the ragged edge is masked in the kernel)."""
    check_method(method)
    rc, tc = row_consts(p, dt), thruster_consts(cfg, lag)

    def fn(x0, U):
        if not same_device(x0, U):
            raise ValueError(f"x0 and U on different devices ({x0.device}, {U.device})")
        if x0.device.type == "cpu":
            return batched_rollout_plain(p, cfg, lag, x0, U, dt, method, use_lag)
        return launch_batched_rollout(rc, tc, x0, U, method, use_lag)

    return fn


def _check_wrench_window(X, TAU) -> None:
    check_kernel_input(X, "X", 12)
    check_kernel_input(TAU, "TAU", 6)
    if not same_device(X, TAU):
        raise ValueError("X and TAU must be on one device")
    check_aligned(TAU, "TAU", 8)


def launch_window_eval_wrench(rc: RowConsts, X, TAU, H: int, method: str):
    """Launch K4; returns the ``(N - H, 12)`` endpoints."""
    check_method(method)
    n_start = check_window_shapes(X, TAU, H, n_in=6)
    _check_wrench_window(X, TAU)
    lib = _build.load_library("window_eval")
    out = torch.empty((n_start, 12), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        code = lib.brov2_window_eval_wrench(
            ctypes.addressof(rc), X.data_ptr(), TAU.data_ptr(), out.data_ptr(),
            n_start, H, METHODS[method], torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(lib, code, "window_eval_wrench")
    _build.launches["window_eval_wrench"] += 1
    return out


def launch_window_sq_wrench(rc: RowConsts, X, TAU, H: int, method: str):
    """Launch K4 fused; returns the 0-d float32 sum of the squared endpoint
    errors."""
    check_method(method)
    n_start = check_window_shapes(X, TAU, H, n_in=6)
    _check_wrench_window(X, TAU)
    lib = _build.load_library("window_eval")
    with torch.cuda.device(X.device):
        n_blocks = wrench_plan(n_start, H, sm_count(X.device))["n_blocks"]
        sq, partials, ticket, stream = sq_scratch(X, n_blocks)
        code = lib.brov2_window_sq_wrench(
            ctypes.addressof(rc), X.data_ptr(), TAU.data_ptr(), sq.data_ptr(),
            partials.data_ptr(), partials.numel(), ticket.data_ptr(), n_start, H,
            METHODS[method], stream)
    _build.check(lib, code, "window_sq_wrench")
    _build.launches["window_sq_wrench"] += 1
    return sq


PLAN_FIELDS = ("warps", "block", "n_blocks", "blocks_per_sm", "shared_bytes")


def read_plan(lib, fn: str, *args) -> dict:
    """The plan a window kernel's occupancy query ``fn(*args, int* plan)``
    reports: :data:`PLAN_FIELDS`."""
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    _build.check(lib, getattr(lib, fn)(*args, plan), fn)
    return dict(zip(PLAN_FIELDS, plan))


def wrench_occupancy(n_start: int, method: str = "euler", fused: bool = False) -> dict:
    """K4's plan for ``n_start`` starts as its launcher makes it on the
    current card, with the resident blocks per SM and static shared bytes
    of the kernel it picks (the endpoint or ``fused`` form)."""
    check_method(method)
    return read_plan(_build.load_library("window_eval"), "brov2_window_wrench_occupancy",
                     METHODS[method], int(fused), n_start)


def make_endpoint_final_cuda_wrench(p: FossenParams, dt: float, H: int,
                                   method: str = "rk4"):
    """Build ``fn(X, TAU) -> (N - H, 12)`` endpoint states of the
    wrench-input euler12 model; feed into ``rmse(X[H:], final)``."""
    check_method(method)
    rc = row_consts(p, dt)

    def fn(X, TAU):
        if not same_device(X, TAU):
            raise ValueError(f"X and TAU on different devices ({X.device}, {TAU.device})")
        if X.device.type == "cpu":
            return endpoint_final_wrench_plain(p, X, TAU, dt, H, method)
        return launch_window_eval_wrench(rc, X, TAU, H, method)

    return fn


def window_sq_wrench_plain(p: FossenParams, X, TAU, dt: float, H: int, method: str = "rk4"):
    """Plain PyTorch version of K4 fused: the endpoints of
    :func:`endpoint_final_wrench_plain`, then :func:`endpoint_sq`."""
    return endpoint_sq(endpoint_final_wrench_plain(p, X, TAU, dt, H, method), X, H)


def make_endpoint_sq_cuda_wrench(p: FossenParams, dt: float, H: int, method: str = "rk4"):
    """Build ``fn(X, TAU) -> 0-d float32``, the sum of the squared endpoint
    errors of the wrench-input euler12 model: K4 fused on CUDA tensors,
    :func:`window_sq_wrench_plain` on CPU tensors."""
    check_method(method)
    rc = row_consts(p, dt)

    def fn(X, TAU):
        if not same_device(X, TAU):
            raise ValueError(f"X and TAU on different devices ({X.device}, {TAU.device})")
        if X.device.type == "cpu":
            return window_sq_wrench_plain(p, X, TAU, dt, H, method)
        return launch_window_sq_wrench(rc, X, TAU, H, method)

    return fn

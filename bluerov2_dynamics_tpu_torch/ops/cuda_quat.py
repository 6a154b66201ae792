"""K5 and K6: the quat13 wrench-input kernels, as CUDA kernels and their
plain PyTorch versions.

* K5 replaces ``ops/pallas_quat.py::_make_quat_window_kernel`` of the JAX
  package (reached through ``make_endpoint_final_pallas_quat``): for every
  start ``s < N - H``, H steps from ``X[s] (13,)`` under the body wrench
  ``TAU[s + t]``; the ``(N - H, 13)`` endpoints feed the T4 app's
  endpoint RMSE.  Its fused form (``make_endpoint_sq_cuda_quat``) reduces
  the squared endpoint errors to one float32 in the kernel, as K2's and
  K4's do (``ops/cuda_eval.py``).
* K6 replaces ``make_rollout_final_pallas_quat``: B starts advance T steps
  under one shared wrench sequence ``TAU (T, 6)`` -> ``(B, 13)``.

Both normalise the quaternion at every RHS entry by one rsqrt with the
identity fallback (never hoisted out of the RK4 stages), take the
restoring wrench from the third DCM row and renormalise after every step
when ``renormalize``.  ``csrc/quat.cu`` runs K6 one thread per
trajectory with its 13 states in registers, staging ``TAU`` through shared
memory; K5 runs one thread a start with each block's wrench rows staged
in shared memory (:func:`quat_plan`, ``csrc/window_rows.cuh``).
The quat13 step is trig-free, so both are bound by FP32 operations on the
H100 (~877 flops and 5 rsqrt per RK4 step, 212 and 2 per Euler step).

The plain versions are the row form of the JAX kernel body
(``normalize_q_rows`` / ``make_rhs_quat_rows`` / ``quat_step_rows``, the
twins of ``_normalize_q_rows`` / ``_make_rhs_quat_rows`` /
``_quat_step_rows``), with the kernels' association order.  The CPU tests
hold them against the Pallas kernels in interpret mode; ``chip_smoke.py``
holds the kernels against them on the card.  The wrappers dispatch on the
tensors' device: CPU tensors take the plain version; CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from bluerov2_dynamics_tpu_torch.models.params import FossenParams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import (
    WINDOW_THREADS,
    WindowConsts,
    check_aligned,
    check_window_shapes,
    endpoint_sq,
    read_plan,
    sm_count,
    split_plan,
    sq_scratch,
)
from bluerov2_dynamics_tpu_torch.ops.cuda_rollout import (
    METHODS,
    RowConsts,
    check_kernel_input,
    check_method,
    make_hydro_rows,
    rk4_rows,
    row_consts,
    same_device,
)
from bluerov2_dynamics_tpu_torch.ops.quaternion import _NORM_EPS
from bluerov2_dynamics_tpu_torch.utils.profiling import span


# ---------------------------------------------------------------------------
# Plain version: the row form
# ---------------------------------------------------------------------------

def normalize_q_rows(qw, qx, qy, qz):
    """Row-wise quaternion normalise by one rsqrt of the squared norm, with
    the identity fallback below norm 1e-12.  The select comes before the
    product, since ``rsqrt(0) * 0`` would be NaN."""
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    small = n2 < _NORM_EPS * _NORM_EPS
    inv = torch.where(small, torch.zeros_like(n2), torch.rsqrt(n2))
    one_if_small = small.to(n2.dtype)
    return qw * inv + one_if_small, qx * inv, qy * inv, qz * inv


def make_rhs_quat_rows(p: FossenParams):
    """quat13 wrench-input RHS on the 13-tuple row state
    ``(x, y, z, qw, qx, qy, qz, u, v, w, p, q, r)``; ``tau`` is a
    6-sequence of scalars or ``(B,)`` rows.  The hydrodynamics are the
    euler12 RHS's (``make_hydro_rows``)."""
    hydro = make_hydro_rows(p)

    def rhs(x, tau):
        qw, qx, qy, qz = normalize_q_rows(x[3], x[4], x[5], x[6])
        nu = (x[7], x[8], x[9], x[10], x[11], x[12])
        pp, q, r = nu[3], nu[4], nu[5]
        R = (
            1.0 - 2.0 * (qy * qy + qz * qz),
            2.0 * (qx * qy - qz * qw),
            2.0 * (qx * qz + qy * qw),
            2.0 * (qx * qy + qz * qw),
            1.0 - 2.0 * (qx * qx + qz * qz),
            2.0 * (qy * qz - qx * qw),
            2.0 * (qx * qz - qy * qw),
            2.0 * (qy * qz + qx * qw),
            1.0 - 2.0 * (qx * qx + qy * qy),
        )
        (px, py, pz), nd = hydro(R, nu, tau)
        qdw = 0.5 * (-qx * pp - qy * q - qz * r)
        qdx = 0.5 * (qw * pp + qy * r - qz * q)
        qdy = 0.5 * (qw * q - qx * r + qz * pp)
        qdz = 0.5 * (qw * r + qx * q - qy * pp)
        return (px, py, pz, qdw, qdx, qdy, qdz) + nd

    return rhs


def quat_step_rows(rhs, xs, tau, dt: float, method: str, renormalize: bool):
    """One integrator step on the 13-tuple, then the optional renormalise."""
    xs = rk4_rows(rhs, xs, tau, dt, method)
    if renormalize:
        xs = xs[:3] + normalize_q_rows(xs[3], xs[4], xs[5], xs[6]) + xs[7:]
    return xs


def endpoint_final_quat_plain(p: FossenParams, X, TAU, dt: float, H: int,
                              method: str = "euler", renormalize: bool = True):
    """Plain PyTorch version of K5: ``(N - H, 13)`` endpoint states of all
    sliding-window rollouts of the quat13 model under ``TAU (N, 6)``."""
    check_method(method)
    n_start = check_window_shapes(X, TAU, H, n_state=13, n_in=6)
    rhs = make_rhs_quat_rows(p)
    xs = tuple(X[:n_start].to(torch.float32).unbind(-1))
    Tf = TAU.to(torch.float32)
    for t in range(H):
        xs = quat_step_rows(rhs, xs, tuple(Tf[t:t + n_start].unbind(-1)), dt, method,
                            renormalize)
    return torch.stack(xs, dim=-1)


def check_rollout_shapes(x0, TAU) -> None:
    if x0.ndim != 2 or x0.shape[1] != 13:
        raise ValueError(f"x0 must be (B, 13), got {tuple(x0.shape)}")
    if TAU.ndim != 2 or TAU.shape[1] != 6:
        raise ValueError(f"TAU must be (T, 6), got {tuple(TAU.shape)}")


def rollout_final_quat_plain(p: FossenParams, x0, TAU, dt: float, method: str = "rk4",
                             renormalize: bool = True):
    """Plain PyTorch version of K6: ``x0 (B, 13)`` under the shared wrench
    sequence ``TAU (T, 6)`` -> ``(B, 13)``."""
    check_method(method)
    check_rollout_shapes(x0, TAU)
    rhs = make_rhs_quat_rows(p)
    xs = tuple(x0.to(torch.float32).unbind(-1))
    Tf = TAU.to(torch.float32)
    for t in range(TAU.shape[0]):
        xs = quat_step_rows(rhs, xs, tuple(Tf[t].unbind()), dt, method, renormalize)
    return torch.stack(xs, dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# csrc/quat.cu's K5 constants: one thread a start, no pair form (a warp
# pair measured slower at every start count, PERF.md)
QUAT_CONSTS = WindowConsts(threads=WINDOW_THREADS, tau_chunk=128)


def quat_plan(n_start: int, H: int, sms: int) -> dict:
    """K5's launch plan (``cuda_eval.split_plan`` of ``QUAT_CONSTS``)."""
    return split_plan(QUAT_CONSTS, n_start, H, sms)


def quat_occupancy(n_start: int, method: str = "euler", renormalize: bool = True,
                   fused: bool = False) -> dict:
    """K5's plan for ``n_start`` starts as its launcher makes it on the
    current card, with the resident blocks per SM and static shared bytes
    of the kernel it picks."""
    check_method(method)
    return read_plan(_build.load_library("quat"), "brov2_window_quat_occupancy",
                     METHODS[method], int(renormalize), int(fused), n_start)


def _check_quat_window(X, TAU) -> None:
    check_kernel_input(X, "X", 13)
    check_kernel_input(TAU, "TAU", 6)
    if not same_device(X, TAU):
        raise ValueError("X and TAU must be on one device")
    check_aligned(TAU, "TAU", 8)


def launch_window_eval_quat(rc: RowConsts, X, TAU, H: int, method: str,
                            renormalize: bool):
    """Launch K5; returns the ``(N - H, 13)`` endpoints."""
    check_method(method)
    n_start = check_window_shapes(X, TAU, H, n_state=13, n_in=6)
    _check_quat_window(X, TAU)
    lib = _build.load_library("quat")
    out = torch.empty((n_start, 13), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        code = lib.brov2_window_eval_quat(
            ctypes.addressof(rc), X.data_ptr(), TAU.data_ptr(), out.data_ptr(), n_start, H,
            METHODS[method], int(renormalize), torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(lib, code, "window_eval_quat")
    _build.launches["window_eval_quat"] += 1
    return out


def launch_window_sq_quat(rc: RowConsts, X, TAU, H: int, method: str, renormalize: bool):
    """Launch K5 fused; returns the 0-d float32 sum of the squared endpoint
    errors.  The whole call is the span ``brov2.wrapper.launch``."""
    with span("brov2.wrapper.launch"):
        check_method(method)
        n_start = check_window_shapes(X, TAU, H, n_state=13, n_in=6)
        _check_quat_window(X, TAU)
        lib = _build.load_library("quat")
        with torch.cuda.device(X.device):
            n_blocks = quat_plan(n_start, H, sm_count(X.device))["n_blocks"]
            sq, partials, ticket, stream = sq_scratch(X, n_blocks)
            code = lib.brov2_window_sq_quat(
                ctypes.addressof(rc), X.data_ptr(), TAU.data_ptr(), sq.data_ptr(),
                partials.data_ptr(), partials.numel(), ticket.data_ptr(), n_start, H,
                METHODS[method], int(renormalize), stream)
        _build.check(lib, code, "window_sq_quat")
        _build.launches["window_sq_quat"] += 1
        return sq


def make_endpoint_final_cuda_quat(p: FossenParams, dt: float, H: int,
                                  method: str = "euler", renormalize: bool = True):
    """Build ``fn(X, TAU) -> (N - H, 13)`` endpoint states of the quat13
    wrench-input model; feed into ``rmse(X[H:], final)``.  The constants
    are read once here and passed at launch."""
    check_method(method)
    rc = row_consts(p, dt)

    def fn(X, TAU):
        if not same_device(X, TAU):
            raise ValueError(f"X and TAU on different devices ({X.device}, {TAU.device})")
        if X.device.type == "cpu":
            return endpoint_final_quat_plain(p, X, TAU, dt, H, method, renormalize)
        return launch_window_eval_quat(rc, X, TAU, H, method, renormalize)

    return fn


def window_sq_quat_plain(p: FossenParams, X, TAU, dt: float, H: int, method: str = "euler",
                         renormalize: bool = True):
    """Plain PyTorch version of K5 fused: the endpoints of
    :func:`endpoint_final_quat_plain`, then ``cuda_eval.endpoint_sq``."""
    return endpoint_sq(endpoint_final_quat_plain(p, X, TAU, dt, H, method, renormalize), X, H)


def make_endpoint_sq_cuda_quat(p: FossenParams, dt: float, H: int, method: str = "euler",
                               renormalize: bool = True):
    """Build ``fn(X, TAU) -> 0-d float32``, the sum of the squared endpoint
    errors of the quat13 wrench-input model: K5 fused on CUDA tensors,
    :func:`window_sq_quat_plain` on CPU tensors."""
    check_method(method)
    rc = row_consts(p, dt)

    def fn(X, TAU):
        if not same_device(X, TAU):
            raise ValueError(f"X and TAU on different devices ({X.device}, {TAU.device})")
        if X.device.type == "cpu":
            return window_sq_quat_plain(p, X, TAU, dt, H, method, renormalize)
        return launch_window_sq_quat(rc, X, TAU, H, method, renormalize)

    return fn


def launch_rollout_quat(rc: RowConsts, x0, TAU, method: str, renormalize: bool):
    """Launch K6 on ``x0 (B, 13)`` under ``TAU (T, 6)``."""
    check_method(method)
    check_rollout_shapes(x0, TAU)
    check_kernel_input(x0, "x0", 13)
    check_kernel_input(TAU, "TAU", 6)
    if not same_device(x0, TAU):
        raise ValueError("x0 and TAU must be on one device")
    out = torch.empty_like(x0)
    B, T = x0.shape[0], TAU.shape[0]
    if B == 0:
        return out
    lib = _build.load_library("quat")
    with torch.cuda.device(x0.device):
        code = lib.brov2_rollout_final_quat(
            ctypes.addressof(rc), TAU.data_ptr(), x0.data_ptr(), out.data_ptr(), B, T,
            METHODS[method], int(renormalize), torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(lib, code, "rollout_final_quat")
    _build.launches["rollout_final_quat"] += 1
    return out


def make_rollout_final_cuda_quat(p: FossenParams, dt: float, method: str = "rk4",
                                 renormalize: bool = True):
    """Build ``fn(x0, TAU) -> xT``: ``x0 (B, 13)``, shared wrench sequence
    ``TAU (T, 6)``.  Any B works (the ragged edge is masked in the
    kernel)."""
    check_method(method)
    rc = row_consts(p, dt)

    def fn(x0, TAU):
        if not same_device(x0, TAU):
            raise ValueError(f"x0 and TAU on different devices ({x0.device}, {TAU.device})")
        if x0.device.type == "cpu":
            return rollout_final_quat_plain(p, x0, TAU, dt, method, renormalize)
        return launch_rollout_quat(rc, x0, TAU, method, renormalize)

    return fn

"""Operations, bytes and the published peaks every roofline and mfu metric uses.

A frozen copy of the port's audited step budgets (``eval/op_counts.py`` of
``bluerov2_dynamics_tpu_torch`` as this benchmark was written), kept here so
that a change to the program cannot move the yardstick.  An IEEE division or
an rsqrt is priced at 8 FP32 operations, an exact sinf/cosf at 16; the cheap
operations (abs, compare, select) are left out.  Every input byte is counted
read once and every output byte written once.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense: FP32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ROW_BUDGET = {
    "rk4": dict(flops=684, div=8, sqrt=0, trig=24),
    "euler": dict(flops=156, div=2, sqrt=0, trig=6),
}
QUAT_BUDGET = {
    "rk4": dict(flops=877, div=0, sqrt=5),
    "euler": dict(flops=212, div=0, sqrt=2),
}
CURVE_OPS = 10      # per thruster and step: V*V, four multiply-adds, a multiply
LAG_OPS = 26        # three rows of 4 mul + 3 add, then c . N
DIV_OPS, TRIG_OPS = 8, 16
SQ_ERR_OPS = 3      # per state component of an error: sub, mul, add


def row_ops(method: str) -> int:
    """One euler12 row step."""
    b = ROW_BUDGET[method]
    return b["flops"] + DIV_OPS * b["div"] + TRIG_OPS * b["trig"]


def quat_ops(method: str) -> int:
    """One quat13 step, renormalised (rsqrt priced as a division)."""
    b = QUAT_BUDGET[method]
    return b["flops"] + DIV_OPS * b["sqrt"]


def wrench_nnz(wrench_map: torch.Tensor) -> int:
    """Non-zero entries of a wrench map (entries below 1e-12 of its largest
    are rounding of a zero)."""
    w = wrench_map.abs()
    return int((w > 1e-12 * float(w.max())).sum())


def actuation_ops(nnz: int, thrusters: int = 8) -> int:
    """Curve, lag and wrench map of one step for all thrusters."""
    return thrusters * (CURVE_OPS + LAG_OPS) + 2 * nnz - 6


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the FP32 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def window_ops(state: str, method: str, n_start: int, H: int, nnz: int) -> int:
    """A window evaluator at ``H``: every start stepped ``H`` times, the
    endpoint error squared and summed."""
    width = 12 if state == "euler12" else 13
    per = row_ops(method) + actuation_ops(nnz) if state == "euler12" else quat_ops(method)
    return n_start * (H * per + width * SQ_ERR_OPS)


def window_bytes(state: str, N: int) -> int:
    """The recording read once (states and inputs), one float written."""
    width, n_in = (12, 8) if state == "euler12" else (13, 6)
    return 4 * (N * (width + n_in) + 1)


def rollout_ops(method: str, B: int, T: int, nnz: int) -> int:
    """K1: B rows of T steps, the shared command sequence's actuation once."""
    return B * T * row_ops(method) + T * actuation_ops(nnz)


def rollout_bytes(B: int, T: int) -> int:
    return 4 * (2 * B * 12 + T * 8)


def fit_ops(method: str, n_start: int, horizon: int, steps: int, nnz: int) -> int:
    """A fit: each Adam step's forward window loss by the step budget, its
    backward at twice the forward."""
    forward = n_start * horizon * (row_ops(method) + actuation_ops(nnz) + 12 * SQ_ERR_OPS)
    return 3 * forward * steps

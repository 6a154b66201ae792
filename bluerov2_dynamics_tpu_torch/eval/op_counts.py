"""Per-trajectory operation counts of one physics step, and what they cost.

The port's own copy of the JAX package's jaxpr audits of its kernel steps
(``bench.py``: ``_vector_op_buckets`` on ``_pallas_kernel_step``,
``step_trig_count`` and ``quat_step_op_counts``), read on the CPU and held
here by a test (``tests/test_torch_probes.py``).  The buckets are vector
operations per trajectory and step:

* ``flops``: add, sub and mul;
* ``div``: IEEE divisions; ``sqrt``: sqrt and rsqrt;
* ``cheap``: abs, neg, compare, select and max, one issue slot each;
* ``slots``: the least issue slots under maximal mul+add fusion,
  ``muls + adds - min(muls, adds) + cheap``;
* ``trig`` (euler12 only): sin and cos evaluations.

The euler12 row step includes the RHS's sin/cos of the Euler angles and the
divisions of the Euler-angle rates; the quat13 step includes the
per-stage and post-step quaternion normalise.
"""

from __future__ import annotations

ROW_BUDGET = {
    "rk4": dict(flops=684, div=8, sqrt=0, cheap=60, slots=472, trig=24),
    "euler": dict(flops=156, div=2, sqrt=0, cheap=15, slots=112, trig=6),
}
QUAT_BUDGET = {
    "rk4": dict(flops=877, div=0, sqrt=5, cheap=47, slots=577),
    "euler": dict(flops=212, div=0, sqrt=2, cheap=14, slots=146),
}
# (flops, divisions, sin/cos) of the euler12 row step; (flops, rsqrt) of
# the quat13 step
ROW_STEP = {m: (b["flops"], b["div"], b["trig"]) for m, b in ROW_BUDGET.items()}
QUAT_STEP = {m: (b["flops"], b["sqrt"]) for m, b in QUAT_BUDGET.items()}

# Actuation per thruster and step (K2, K3): the T200 curve is V*V, four
# multiply-adds and a final multiply; the lag is three rows of 4 mul + 3
# add, then c.N.  The wrench map adds 2 * nnz - 6.
CURVE_OPS = 10
LAG_OPS = 26

# Published-peak prices: an IEEE division or an rsqrt at 8 FP32
# operations (reciprocal estimate and Newton refinement), an exact
# sinf/cosf at 16 (range reduction, minimax polynomial, quadrant
# selection).  Estimates, not counted instructions; the cheap ops are left
# out.  The measured prices come from the ceiling probes
# (``ops/cuda_probes.py``).
DIV_OPS, TRIG_OPS = 8, 16


def actuation_ops(nnz: int) -> int:
    """Operations of the curve, lag and wrench map per step, for a wrench
    map with ``nnz`` non-zero entries."""
    return 8 * (CURVE_OPS + LAG_OPS) + 2 * nnz - 6


def row_ops(method: str) -> int:
    """Published-peak operations of one euler12 row step."""
    flops, div, trig = ROW_STEP[method]
    return flops + DIV_OPS * div + TRIG_OPS * trig


def quat_ops(method: str) -> int:
    """Published-peak operations of one quat13 step (rsqrt priced as a
    division)."""
    flops, rsqrt = QUAT_STEP[method]
    return flops + DIV_OPS * rsqrt

"""Operations and bytes of the Koopman EDMDc fit and scoring, frozen with the
benchmark as ``opcounts.py`` is.

What the algorithm needs, counted from the configuration's widths and a
request's shapes, at ``opcounts.py``'s prices: a GEMM at 2 * m * k * n, an
add or multiply at 1, a division at ``DIV_OPS``, an exp at ``TRIG_OPS``;
compare, select, argmin and the one-hot's zeros are left out.  ``N`` rows of
``n`` states, ``r`` inputs, ``k`` centers, the lift ``d = n + k`` wide.  The
normal equations run in float64 (the Gram, the right-hand side, the
Cholesky and its solves), everything else in float32; both are priced
against the same 67 TFLOP/s (the FP32 peak outside the tensor cores, and
the H100's FP64 tensor-core peak).
"""

from __future__ import annotations

from portbench.opcounts import DIV_OPS, SQ_ERR_OPS, TRIG_OPS


def sqdist_ops(N: int, k: int, n: int) -> int:
    """The Gram expansion: ``|x|^2`` a row, ``|c|^2`` a center, the cross
    GEMM, and ``x2 + c2 - 2 cross`` (3) a pair."""
    return 2 * n * N + 2 * n * k + N * k * (2 * n + 3)


def lift_ops(N: int, k: int, n: int) -> int:
    """``N`` rows lifted: the distances, ``-gamma *`` and the exp a pair."""
    return sqdist_ops(N, k, n) + N * k * (1 + TRIG_OPS)


def seed_ops(N: int, k: int, n: int) -> int:
    """k-means++: each of the ``k - 1`` draws after the first takes every
    row's squared distance to the newest center (3 a coordinate), the
    running minimum's sum and the probabilities (a division a row)."""
    return (k - 1) * N * (3 * n + 1 + DIV_OPS)


def lloyd_ops(N: int, k: int, n: int, iters: int) -> int:
    """``iters`` rounds of the distances, the one-hot GEMM of the sums, the
    counts and the means' divisions, then the final assignment's distances."""
    one = sqdist_ops(N, k, n) + 2 * N * k * n + N * k + DIV_OPS * k * n
    return iters * one + sqdist_ops(N, k, n)


def gram_ops(pairs: int, d: int, r: int) -> int:
    """``G^T G`` and ``G^T Z+`` of the ``pairs x (d + r)`` matrix ``G``: the
    Gram is symmetric, so its needed half at ``pairs * m^2`` (``m = d + r``),
    the right-hand side a full GEMM."""
    m = d + r
    return pairs * m * m + 2 * pairs * m * d


def gram_bytes(pairs: int, d: int, r: int) -> int:
    """Float64 ``G`` and ``Z+`` read once, the two products written once."""
    return 8 * (pairs * (d + r) + pairs * d + (d + r) * (d + r) + (d + r) * d)


def solve_ops(d: int, r: int) -> int:
    """The ridge added, the Cholesky of the ``(d + r)`` square (``m^3 / 3``)
    and its two triangular solves for ``d`` right-hand sides."""
    m = d + r
    return m + m ** 3 // 3 + 2 * m * m * d


def fit_ops(N: int, k: int, n: int, r: int, iters: int) -> int:
    """One fit on ``N`` rows: seeding, Lloyd rounds, the two lifts of the
    ``N - 1`` pairs, the Gram and the solve."""
    d = n + k
    return (seed_ops(N, k, n) + lloyd_ops(N, k, n, iters) + 2 * lift_ops(N - 1, k, n)
            + gram_ops(N - 1, d, r) + solve_ops(d, r))


def prop_ops(n_start: int, H: int, d: int, r: int) -> int:
    """The propagation's GEMMs: ``H`` steps of ``z A^T`` and ``u B^T`` for
    every start."""
    return 2 * n_start * H * d * (d + r)


def prop_bytes(n_start: int, H: int, d: int, r: int) -> int:
    """Float32: each step reads ``z``, the step's inputs, ``A`` and ``B`` and
    writes ``z`` once."""
    return 4 * H * (n_start * (2 * d + r) + d * (d + r))


def score_ops(N: int, H: int, k: int, n: int, r: int) -> int:
    """One horizon of a scoring over the ``N - H`` starts of ``N`` rows: the
    lift, the propagation's GEMMs and adds, the squared error and its sum."""
    n_start, d = N - H, n + k
    return (lift_ops(n_start, k, n) + prop_ops(n_start, H, d, r) + n_start * H * d
            + n_start * n * SQ_ERR_OPS)

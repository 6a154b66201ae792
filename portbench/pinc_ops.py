"""Operations of PINc training, frozen with the benchmark as ``opcounts.py`` is.

What the algorithm needs, counted from the configuration's widths and a
request's shapes, at ``opcounts.py``'s prices: a GEMM at 2 * in * out, an
elementwise add or multiply at 1, a division, square root or rsqrt at
``DIV_OPS``, an exp or a log at ``TRIG_OPS`` (the transcendental price);
the cheap operations (abs, compare, select, max) are left out.  A
minibatch step runs the net forward on its ``batch`` rows and on ``windows
* steps`` rollout rows, takes the MSE of each of them, the reduced model's
right-hand side on the batch rows, the backward at twice the forward, and
one clipped AdamW update of every parameter.
"""

from __future__ import annotations

from portbench.opcounts import DIV_OPS, SQ_ERR_OPS, TRIG_OPS

STATE = 9
# beta * x, the add of logaddexp(y, 0) = max(y, 0) + log1p(exp(-|y|)) and
# the 1 + of log1p; its exp and log; the division by beta
SOFTPLUS_OPS = 3 + 2 * TRIG_OPS + DIV_OPS
# an element: x * x, its two running sums, x - mean, rsqrt * scale, the
# product, + bias
LN_ELEMENT_OPS = 7
# a row: the two means' divisions, mean^2 and the subtraction, + eps, rsqrt
LN_ROW_OPS = 3 * DIV_OPS + 3
# the yaw rotation of the x, y residual (4 mul, 2 add), the residual added
# (9), |(cos, sin)|^2 and its root, the two divisions, the x and y adds
HEAD_OPS = 6 + STATE + 3 + DIV_OPS + 2 * DIV_OPS + 2
# the reduced right-hand side a row (34 multiplies and adds, 4 divisions),
# then its square and sum
PHYSICS_OPS = 34 + 4 * DIV_OPS + 2 * STATE
# clip (g * g and its sum, g / norm * clip), both moments (3 and 4), the
# bias corrections and the root (3 divisions and a root), + eps, the
# division, weight decay (2), the rate and the add
ADAMW_OPS = 2 + DIV_OPS + 1 + 3 + 4 + 3 * DIV_OPS + DIV_OPS + 1 + DIV_OPS + 2 + 2
BACKWARD_FACTOR = 2


def _widths(net: dict):
    w = [int(net["input_width"])] + [int(h) for h in net["hidden"]]
    return list(zip(w[:-1], w[1:])), w[-1], int(net["output_width"])


def forward_row_ops(net: dict) -> int:
    """One row through the net: the hidden layers, the output layer, the head."""
    hidden, last, out = _widths(net)
    ops = sum(2 * i * o + o + o * (SOFTPLUS_OPS + LN_ELEMENT_OPS) + LN_ROW_OPS
              for i, o in hidden)
    return ops + 2 * last * out + out + HEAD_OPS


def n_params(net: dict) -> int:
    hidden, last, out = _widths(net)
    return sum(i * o + o + 1 + 2 * o for i, o in hidden) + last * out + out


def step_ops(net: dict, batch: int, windows: int, steps: int) -> int:
    """One minibatch step: forward and losses, the backward, the update."""
    rows = batch + windows * steps
    forward = rows * (forward_row_ops(net) + STATE * SQ_ERR_OPS) + batch * PHYSICS_OPS
    return (1 + BACKWARD_FACTOR) * forward + n_params(net) * ADAMW_OPS


def epoch_ops(net: dict, batches: int, batch: int, windows: int, steps: int) -> int:
    return batches * step_ops(net, batch, windows, steps)

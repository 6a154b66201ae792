"""Observable lifts for Koopman system identification.

Counterpart of ``bluerov2_dynamics_tpu/ops/lifting.py``: the Gaussian-RBF
dictionary ``phi(x) = [x, exp(-gamma ||x - c_1||^2), ...]``, computed as
one GEMM over the batch by the Gram expansion ``||x||^2 + ||c||^2 - 2 x
C^T``, natively batched over leading dimensions.

The cross-term GEMM runs in full float32 (:func:`..ops.precision.full_f32`,
never TF32 or bf16): for states far from the origin (a tank recording
with psi wound to ~60 rad gives ``||x||^2 ~ 3.8e3``) a reduced-precision
product errs by more than the distance itself, the "squared distance"
comes out negative, ``exp(-gamma * sqdist)`` overflows and the ridge
solve downstream gives NaN.  The distance is also clamped at zero, since
floating point does not keep it non-negative.
"""

from __future__ import annotations

import torch

from bluerov2_dynamics_tpu_torch.ops.precision import full_f32


@full_f32()
def rbf_features(X, centers, gamma, weights=None):
    """Gaussian RBF features ``exp(-gamma ||w * (x - c)||^2)``.

    ``X``: ``(..., n)``; ``centers``: ``(k, n)``; returns ``(..., k)``.
    ``weights`` (optional, ``(n,)``) rescales coordinates before the
    distance; a 0/1 mask makes the dictionary invariant to the masked
    coordinates.
    """
    if weights is not None:
        X = X * weights
        centers = centers * weights
    x2 = torch.sum(X * X, dim=-1, keepdim=True)         # (..., 1)
    c2 = torch.sum(centers * centers, dim=-1)           # (k,)
    cross = torch.matmul(X, centers.T)                  # (..., k)
    sqdist = torch.clamp(x2 + c2 - 2.0 * cross, min=0.0)
    return torch.exp(-gamma * sqdist)


def rbf_lift(X, centers, gamma, weights=None):
    """Full lift ``phi(x) = [x, rbf(x)]`` of dimension ``d = n + k``."""
    return torch.cat([X, rbf_features(X, centers, gamma, weights)], dim=-1)

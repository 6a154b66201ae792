"""Learned linear "double integrator" (DI) baseline model (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/di.py`` in its three
variants: the discrete euler12 step (body-frame velocities integrated, a
small-angle attitude update, the position through R_b2n), the same model
as a continuous RHS under RK4, and the discrete quat13 step with the
quaternion renormalised before and after.

The gains are ridge solves over forward-differenced velocities, for any
input width (8 thruster commands or a 6-D wrench).  Every step is batched
over leading dimensions; the endpoint evaluator is
:func:`bluerov2_dynamics_tpu_torch.eval.metrics.endpoint_rmse`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bluerov2_dynamics_tpu_torch.ops.integrators import rk4_step, rollout
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.ops.quaternion import (
    quat_derivative,
    quat_normalize,
    quat_rotate,
)
from bluerov2_dynamics_tpu_torch.ops.rotations import rotate_b2n


class DIGains(NamedTuple):
    K_lin: torch.Tensor  # (r, 3) input -> body linear acceleration
    K_ang: torch.Tensor  # (r, 3) input -> body angular acceleration


def estimate_gains(X_train, U_train, dt, ridge: float = 1e-3) -> DIGains:
    """Ridge-solve the input -> acceleration maps from forward differences.

    The velocities are the last six state columns (euler12 columns 6:12,
    quat13 columns 7:13).  The Gram and right-hand sides are formed with
    TF32 off, as the JAX package forms them at ``"highest"`` precision, and
    solved by Cholesky (``assume_a="pos"``); a Gram whose factorisation
    fails gives NaN gains, as ``jax.scipy.linalg.solve`` does.
    """
    vel = X_train[:, -6:]
    dvel = (vel[1:] - vel[:-1]) / max(float(dt), 1e-9)
    G = U_train[:-1]
    with full_f32():
        gram = G.T @ G
        rhs_lin = G.T @ dvel[:, 0:3]
        rhs_ang = G.T @ dvel[:, 3:6]
        gram = gram + ridge * torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        L, info = torch.linalg.cholesky_ex(gram)
        K = torch.cholesky_solve(torch.cat([rhs_lin, rhs_ang], dim=1), L)
    K = torch.where(info > 0, torch.full_like(K, float("nan")), K)
    return DIGains(K_lin=K[:, 0:3], K_ang=K[:, 3:6])


def di_rhs_euler12(gains: DIGains, x, u):
    """Continuous-time DI RHS on the euler12 state: ``dpos = R v``,
    ``dang = omega``, ``dv = u K_lin``, ``domega = u K_ang``."""
    phi, theta, psi = x[..., 3], x[..., 4], x[..., 5]
    v = x[..., 6:9]
    w = x[..., 9:12]
    dpos = rotate_b2n(phi, theta, psi, v)
    return torch.cat([dpos, w, u @ gains.K_lin, u @ gains.K_ang], dim=-1)


def make_step_euler12(gains: DIGains, dt: float):
    """Discrete DI step (semi-explicit, small-angle attitude): position and
    attitude advance with the *current* velocities, then the velocities
    update."""

    def step(x, u):
        phi, theta, psi = x[..., 3], x[..., 4], x[..., 5]
        v = x[..., 6:9]
        w = x[..., 9:12]
        pos_next = x[..., 0:3] + dt * rotate_b2n(phi, theta, psi, v)
        ang_next = x[..., 3:6] + dt * w
        v_next = v + dt * (u @ gains.K_lin)
        w_next = w + dt * (u @ gains.K_ang)
        return torch.cat([pos_next, ang_next, v_next, w_next], dim=-1)

    return step


def make_step_euler12_rk4(gains: DIGains, dt: float):
    """RK4 step of the continuous DI RHS."""

    def step(x, u):
        return rk4_step(lambda xx, uu: di_rhs_euler12(gains, xx, uu), x, u, dt)

    return step


def make_step_quat13(gains: DIGains, dt: float):
    """Discrete DI step on the quat13 state, the quaternion normalised on
    entry and again after its update."""

    def step(x, u):
        q = quat_normalize(x[..., 3:7])
        v = x[..., 7:10]
        w = x[..., 10:13]
        pos_next = x[..., 0:3] + dt * quat_rotate(q, v)
        q_next = quat_normalize(q + dt * quat_derivative(q, w))
        v_next = v + dt * (u @ gains.K_lin)
        w_next = w + dt * (u @ gains.K_ang)
        return torch.cat([pos_next, q_next, v_next, w_next], dim=-1)

    return step


_VARIANTS = {
    "euler12": make_step_euler12,
    "euler12_rk4": make_step_euler12_rk4,
    "quat13": make_step_quat13,
}


def simulate(gains: DIGains, x0, U_seq, dt: float, variant: str = "euler12"):
    """Open-loop DI rollout; returns ``(T+1, n)`` with ``x0`` in row 0."""
    _, traj = rollout(_VARIANTS[variant](gains, dt), x0, U_seq, include_initial=True)
    return traj

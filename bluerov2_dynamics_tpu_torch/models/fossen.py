"""Fossen 6-DOF BlueROV2 dynamics, euler12 and quat13 states (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/fossen.py`` in two state
conventions:

* euler12, ``x = [x, y, z, phi, theta, psi, u, v, w, p, q, r]``, under
  either 8 normalised thruster commands (through curve, lag and wrench
  map) or a direct 6-D body wrench;
* quat13, ``x = [x, y, z, qw, qx, qy, qz, u, v, w, p, q, r]``, under a
  direct 6-D body wrench, with the quaternion normalised on every RHS
  entry and, optionally, after every step.

The mass matrix is diagonal and the Coriolis and damping matrices sparse,
so ``nu_dot`` is written in closed form.  All functions broadcast over
leading batch dimensions.  :func:`reduced_rhs` is the reduced 9-state
model of the PINc physics loss.
"""

from __future__ import annotations

from typing import Callable

import torch

from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ReducedParams,
    ThrusterConfig,
)
from bluerov2_dynamics_tpu_torch.models.thrusters import (
    thruster_wrench,
    thruster_wrench_nolag,
)
from bluerov2_dynamics_tpu_torch.ops.integrators import get_stepper, rollout
from bluerov2_dynamics_tpu_torch.ops.quaternion import (
    quat_derivative,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
)
from bluerov2_dynamics_tpu_torch.ops.rotations import (
    euler_rates,
    rotate_b2n,
    rotate_n2b,
)


# ---------------------------------------------------------------------------
# Hydrodynamic terms (closed-form products, no matrices)
# ---------------------------------------------------------------------------

def coriolis_nu(p: FossenParams, nu):
    """``C(nu) @ nu`` with ``C = CRB + CA`` in closed form; the rigid-body
    ``m`` terms of the moment rows cancel, leaving ``FossenParams.gyro``."""
    u, v, w = nu[..., 0], nu[..., 1], nu[..., 2]
    pp, q, r = nu[..., 3], nu[..., 4], nu[..., 5]
    mx, my, mz = p.mdiag[0], p.mdiag[1], p.mdiag[2]
    Xud, Yvd, Zwd = p.added[0], p.added[1], p.added[2]
    return torch.stack(
        [
            mz * w * q - my * v * r,
            -mz * w * pp + mx * u * r,
            my * v * pp - mx * u * q,
            p.gyro[0] * q * r + (Yvd - Zwd) * v * w,
            p.gyro[1] * pp * r + (Zwd - Xud) * u * w,
            p.gyro[2] * pp * q + (Xud - Yvd) * u * v,
        ],
        dim=-1,
    )


def damping_nu(p: FossenParams, nu_r):
    """``D(nu_r) @ nu_r``: diagonal linear + quadratic damping."""
    return (p.d_lin + p.d_quad * torch.abs(nu_r)) * nu_r


def restoring_terms(p: FossenParams, sth, cth_sphi, cth_cphi):
    """Restoring wrench ``g(eta)`` from the third row of R_{b->n}
    (``[-sth, cth*sphi, cth*cphi]``)."""
    WB = p.W - p.B
    xbB = p.cb[0] * p.B
    ybB = p.cb[1] * p.B
    zbB = p.cb[2] * p.B
    return torch.stack(
        [
            WB * sth,
            -WB * cth_sphi,
            -WB * cth_cphi,
            ybB * cth_cphi - zbB * cth_sphi,
            -zbB * sth - xbB * cth_cphi,
            xbB * cth_sphi + ybB * sth,
        ],
        dim=-1,
    )


def restoring_euler(p: FossenParams, phi, theta):
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    return restoring_terms(p, sth, cth * sphi, cth * cphi)


def _nu_dot(p: FossenParams, nu, nu_r, tau, gvec):
    """``nu_dot = M^-1 (tau - C nu - D nu_r - g)``, elementwise (M diagonal)."""
    return (tau - coriolis_nu(p, nu) - damping_nu(p, nu_r) - gvec) * p.minv


def _relative_velocity(nu, v_current_body):
    """Subtract the body-frame current from the linear DOFs only."""
    return torch.cat([nu[..., 0:3] - v_current_body, nu[..., 3:6]], dim=-1)


def wrench_rhs_euler(p: FossenParams, x, tau):
    """xdot of the 12-state Euler-angle model under a body wrench ``tau``.

    ``x``: ``(..., 12)``; ``tau``: ``(..., 6)`` (broadcastable).
    """
    phi, theta, psi = x[..., 3], x[..., 4], x[..., 5]
    nu = x[..., 6:12]
    current = p.current.expand(x[..., 0:3].shape)
    v_c_b = rotate_n2b(phi, theta, psi, current)
    nu_r = _relative_velocity(nu, v_c_b)
    gvec = restoring_euler(p, phi, theta)
    nu_dot = _nu_dot(p, nu, nu_r, tau, gvec)
    p_dot = rotate_b2n(phi, theta, psi, nu[..., 0:3])
    eul_dot = euler_rates(phi, theta, nu[..., 3:6])
    return torch.cat([p_dot, eul_dot, nu_dot], dim=-1)


def wrench_rhs_quat(p: FossenParams, x, tau):
    """xdot of the 13-state quaternion model under a body wrench ``tau``.

    The quaternion is normalised on entry, and the restoring wrench comes
    from the third row of R_{b->n}, never from Euler angles.
    """
    q = quat_normalize(x[..., 3:7])
    nu = x[..., 7:13]
    current = p.current.expand(x[..., 0:3].shape)
    nu_r = _relative_velocity(nu, quat_rotate_inv(q, current))
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # third row of R_{b->n}: [-sth, cth*sphi, cth*cphi]
    sth = -2.0 * (qx * qz - qy * qw)
    cth_sphi = 2.0 * (qy * qz + qx * qw)
    cth_cphi = 1.0 - 2.0 * (qx * qx + qy * qy)
    gvec = restoring_terms(p, sth, cth_sphi, cth_cphi)
    nu_dot = _nu_dot(p, nu, nu_r, tau, gvec)
    p_dot = quat_rotate(q, nu[..., 0:3])
    q_dot = quat_derivative(q, nu[..., 3:6])
    return torch.cat([p_dot, q_dot, nu_dot], dim=-1)


def renormalize_quat13(x):
    """Normalise the quaternion block of a quat13 state (post-step hook)."""
    q = quat_normalize(x[..., 3:7])
    return torch.cat([x[..., 0:3], q, x[..., 7:13]], dim=-1)


# ---------------------------------------------------------------------------
# Thruster-input model: step with explicit lag state
# ---------------------------------------------------------------------------

def thruster_dynamics(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    lag_state,
    x,
    u8,
    use_lag: bool = True,
):
    """One RHS evaluation of the thruster-input model; returns
    ``(new_lag_state, xdot)``."""
    if use_lag:
        lag_state, tau = thruster_wrench(cfg, lag, lag_state, u8)
    else:
        tau = thruster_wrench_nolag(cfg, u8)
    return lag_state, wrench_rhs_euler(p, x, tau)


def make_thruster_step(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    dt: float,
    method: str = "euler",
    use_lag: bool = True,
) -> Callable:
    """``step((x, lag_state), u8) -> (x', lag_state')``.

    The lag filter advances once per outer step and its wrench is held
    constant across the RK4 stages.
    """
    stepper = get_stepper(method)

    def step(carry, u8):
        x, lag_state = carry
        if use_lag:
            lag_state, tau = thruster_wrench(cfg, lag, lag_state, u8)
        else:
            tau = thruster_wrench_nolag(cfg, u8)
        x = stepper(lambda xx, tt: wrench_rhs_euler(p, xx, tt), x, tau, dt)
        return (x, lag_state)

    return step


def make_wrench_step(
    p: FossenParams,
    dt: float,
    method: str = "euler",
    state: str = "euler12",
    renormalize: bool = True,
) -> Callable:
    """Discrete step ``step(x, tau) -> x'`` of a wrench-input model.

    ``state`` is ``"euler12"`` or ``"quat13"``; for quat13 the quaternion
    is normalised after each step when ``renormalize``.
    """
    stepper = get_stepper(method)
    if state == "euler12":
        rhs, post = wrench_rhs_euler, None
    elif state == "quat13":
        rhs, post = wrench_rhs_quat, (renormalize_quat13 if renormalize else None)
    else:
        raise ValueError(f"unknown state convention {state!r}")

    def step(x, tau):
        x = stepper(lambda xx, tt: rhs(p, xx, tt), x, tau, dt)
        return x if post is None else post(x)

    return step


def simulate_thruster(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    x0,
    U,
    dt: float,
    method: str = "euler",
    use_lag: bool = True,
    lag_state0=None,
):
    """Open-loop rollout of the thruster-input model.

    ``x0``: ``(..., 12)``; ``U``: ``(T, ..., 8)``.  Returns the trajectory
    ``(T+1, ..., 12)`` with ``x0`` in row 0.
    """
    if lag_state0 is None:
        lag_state0 = torch.zeros((*x0.shape[:-1], 8, 3), dtype=x0.dtype,
                                 device=x0.device)
    step = make_thruster_step(p, cfg, lag, dt, method, use_lag)
    _, (traj, _) = rollout(step, (x0, lag_state0), U, include_initial=True)
    return traj


def simulate_wrench(
    p: FossenParams,
    x0,
    TAU,
    dt: float,
    method: str = "euler",
    state: str = "euler12",
    renormalize: bool = True,
):
    """Open-loop rollout of a wrench-input model (euler12 or quat13);
    ``TAU``: ``(T, ..., 6)``.  Returns ``(T+1, ..., n)`` with ``x0`` in
    row 0."""
    step = make_wrench_step(p, dt, method, state, renormalize)
    _, traj = rollout(step, x0, TAU, include_initial=True)
    return traj


# ---------------------------------------------------------------------------
# Reduced 9-state RHS (the PINc physics loss)
# ---------------------------------------------------------------------------

def reduced_rhs(rp: ReducedParams, x9, u4):
    """xdot of the reduced state ``[x, y, z, cos psi, sin psi, u, v, w, r]``
    under the input ``[X, Y, Z, Mz]``.

    Keeps, term for term, the two sign quirks of the reference model that
    the JAX package keeps (``bluerov2_dynamics_tpu/models/fossen.py:324``).
    """
    cpsi, spsi = x9[..., 3], x9[..., 4]
    u, v, w, r = x9[..., 5], x9[..., 6], x9[..., 7], x9[..., 8]
    X, Y, Z, Mz = u4[..., 0], u4[..., 1], u4[..., 2], u4[..., 3]

    x_d = cpsi * u - spsi * v
    y_d = spsi * u + cpsi * v
    z_d = w
    cpsi_d = -spsi * r
    spsi_d = cpsi * r

    u_d = (X + (rp.m - rp.Y_vd) * v * r + (rp.X_u + rp.X_uc * torch.abs(u)) * u) / (rp.m - rp.X_ud)
    v_d = (Y - (rp.m - rp.X_ud) * u * r + (rp.Y_v + rp.Y_vc * torch.abs(v)) * v) / (rp.m - rp.Y_vd)
    w_d = (Z + (rp.Z_w + rp.Z_wc * torch.abs(w)) * w + rp.m * rp.g - rp.F_buoy) / (rp.m - rp.Z_wd)
    r_d = (Mz - (rp.X_ud - rp.Y_vd) * u * v + (rp.N_r + rp.N_rc * torch.abs(r)) * r) / (rp.I_zz - rp.N_rd)

    return torch.stack([x_d, y_d, z_d, cpsi_d, spsi_d, u_d, v_d, w_d, r_d], dim=-1)

"""Lumped-mass tether model, vectorised over segments (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/tether.py``: node 0 is a
fixed anchor, node n is the ROV; the ``n-1`` internal nodes carry
``6*(n-1)`` states (positions then velocities, NED).  Per segment: axial
tension with a slack cut-off, internal axial damping, and hydrodynamic
drag split along and normal to the cable.  Every per-segment quantity is
one tensor op over the segment axis, batched over leading dimensions.

Behavioural note (kept for parity): the reference computes the drag
component **along** the cable with the *normal* drag coefficient ``Cn``
and the orthogonal component with ``Ct``; the variable names there are
swapped relative to the physics.  The computation is reproduced exactly
and the components are named for what they are.

Stiffness: with E = 6.437e7 the axial mode is stiff.  The coupled rollout
sub-steps an explicit integrator (``substeps`` inner RK4 steps a step,
stable for the default parameters at dt_inner ~ 2.5e-4); the implicit
steps of :mod:`bluerov2_dynamics_tpu_torch.ops.implicit` are the
alternative at a large dt.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TetherConfig:
    """Static tether parameters (the reference's defaults)."""

    n_segments: int = 10
    length: float = 35.0
    diameter: float = 0.0075
    e_modulus: float = 6.437e7
    drag_normal: float = 1.2      # Cn, applied to the along-cable component (see module note)
    drag_tangent: float = 0.01    # Ct, applied to the orthogonal component
    c_internal: float = 100.0
    mass_per_length: float = 0.043
    rho: float = 1000.0

    @property
    def cross_area(self) -> float:
        return math.pi * (0.5 * self.diameter) ** 2

    @property
    def l0(self) -> float:
        return self.length / float(self.n_segments)

    @property
    def node_mass(self) -> float:
        return self.mass_per_length * self.l0

    @property
    def n_states(self) -> int:
        return 0 if self.n_segments < 2 else 6 * (self.n_segments - 1)


def init_nodes_line(cfg: TetherConfig, anchor, rov_pos, dtype=torch.float32, device=None):
    """Internal nodes on the straight line anchor -> ROV, at rest
    (``device=None`` means ``cuda``)."""
    device = resolve_device(device)
    n = cfg.n_segments
    if n < 2:
        return torch.zeros((0,), dtype=dtype, device=device)
    anchor = torch.as_tensor(anchor, dtype=dtype, device=device)
    rov_pos = torch.as_tensor(rov_pos, dtype=dtype, device=device)
    alphas = torch.arange(1, n, dtype=dtype, device=device)[:, None] / n   # (n-1, 1)
    p = anchor + alphas * (rov_pos - anchor)                               # (n-1, 3)
    return torch.cat([p.reshape(-1), torch.zeros(3 * (n - 1), dtype=dtype, device=device)])


def _safe_speed(v):
    """``|v|`` with a finite gradient at ``v = 0`` (the plain norm's
    ``v/|v|`` is NaN at rest, which breaks the implicit steps' Jacobians);
    the value moves by ~1e-12 absolute."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)


def tether_dynamics(cfg: TetherConfig, x_teth, anchor_pos, rov_pos, rov_vel, current_ned):
    """Time derivative of the tether state and the force on the ROV.

    ``x_teth``: ``(..., 6*(n-1))``; anchor/ROV position and velocity and
    the current: ``(..., 3)``.  Returns ``(dx_teth, F_on_rov)`` with
    ``F_on_rov = T_{n-1}``, the last segment's tension.
    """
    n = cfg.n_segments
    if n < 2:
        return torch.zeros_like(x_teth), torch.zeros_like(rov_pos)
    n_i = n - 1
    batch = x_teth.shape[:-1]
    p_int = x_teth[..., :3 * n_i].reshape(*batch, n_i, 3)
    v_int = x_teth[..., 3 * n_i:].reshape(*batch, n_i, 3)

    def node_axis(end_a, mid, end_b):
        a = torch.broadcast_to(end_a[..., None, :], (*batch, 1, 3))
        b = torch.broadcast_to(end_b[..., None, :], (*batch, 1, 3))
        return torch.cat([a, mid, b], dim=-2)                   # (..., n+1, 3)

    pos = node_axis(anchor_pos, p_int, rov_pos)
    vel = node_axis(torch.zeros_like(rov_vel), v_int, rov_vel)

    # segment k connects node k -> k+1, k = 0 .. n-1
    r = pos[..., 1:, :] - pos[..., :-1, :]                       # (..., n, 3)
    L = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True)) + 1e-12
    rhat = r / L

    # axial tension with a slack cut-off
    ea_over_l0 = cfg.e_modulus * cfg.cross_area / cfg.l0
    stretch = L - cfg.l0
    T = torch.where(stretch > 0.0, ea_over_l0 * stretch, torch.zeros_like(stretch)) * rhat

    # internal axial damping
    dv = vel[..., 1:, :] - vel[..., :-1, :]
    P = cfg.c_internal * torch.sum(dv * rhat, dim=-1, keepdim=True) * rhat

    # hydrodynamic drag on segment k from the flow at node k (the
    # reference's coefficient/component pairing, see the module note)
    v_flow = current_ned[..., None, :] - vel[..., :-1, :]
    v_along = torch.sum(v_flow * rhat, dim=-1, keepdim=True) * rhat
    v_orth = v_flow - v_along
    half_rho_d = 0.5 * cfg.rho * cfg.diameter
    F_along = half_rho_d * cfg.drag_normal * L * _safe_speed(v_along) * v_along
    F_orth = half_rho_d * cfg.drag_tangent * L * _safe_speed(v_orth) * v_orth
    F = F_along + F_orth

    # net force on internal node i = T_i - T_{i-1} + P_{i-1} - P_i + F_i
    F_net = T[..., 1:, :] - T[..., :-1, :] + P[..., :-1, :] - P[..., 1:, :] + F[..., 1:, :]
    accel = F_net / cfg.node_mass
    dx = torch.cat([v_int.reshape(*batch, -1), accel.reshape(*batch, -1)], dim=-1)
    return dx, T[..., -1, :]


def coupled_rhs(p, cfg: TetherConfig, x_ext, tau, anchor_pos):
    """RHS of the extended state ``[x12, tether(6*(n-1))]`` under the body
    wrench ``tau``: the tether tension at the ROV end, rotated to the body
    frame, is added to the wrench's force."""
    from bluerov2_dynamics_tpu_torch.models.fossen import wrench_rhs_euler
    from bluerov2_dynamics_tpu_torch.ops.rotations import rotate_b2n, rotate_n2b

    x12 = x_ext[..., :12]
    x_teth = x_ext[..., 12:]
    phi, theta, psi = x12[..., 3], x12[..., 4], x12[..., 5]
    rov_pos = x12[..., 0:3]
    rov_vel_ned = rotate_b2n(phi, theta, psi, x12[..., 6:9])
    current = torch.broadcast_to(p.current, rov_pos.shape)
    anchor_pos = torch.as_tensor(anchor_pos, dtype=x_ext.dtype, device=x_ext.device)
    dx_teth, F_teth_ned = tether_dynamics(cfg, x_teth, anchor_pos, rov_pos, rov_vel_ned, current)
    F_body = rotate_n2b(phi, theta, psi, F_teth_ned)
    tau_total = torch.cat([tau[..., 0:3] + F_body, tau[..., 3:6]], dim=-1)
    xdot12 = wrench_rhs_euler(p, x12, tau_total)
    return torch.cat([xdot12, dx_teth], dim=-1)


def make_coupled_step(
    p,
    thr_cfg,
    lag,
    cfg: TetherConfig,
    anchor_pos,
    dt: float,
    method: str = "rk4",
    substeps: int = 40,
    use_lag: bool = True,
):
    """``step((x_ext, lag_state), u8) -> (x_ext', lag_state')`` for the
    thruster-driven ROV with its tether.  The thruster wrench (lag
    included) is computed once a step; the stiff coupled RHS is integrated
    with ``substeps`` inner steps."""
    from bluerov2_dynamics_tpu_torch.models.thrusters import (
        thruster_wrench,
        thruster_wrench_nolag,
    )
    from bluerov2_dynamics_tpu_torch.ops.integrators import rollout_stepper

    inner = rollout_stepper(lambda x, t: coupled_rhs(p, cfg, x, t, anchor_pos), dt,
                            method=method, substeps=substeps)

    def step(carry, u8):
        x_ext, lag_state = carry
        if use_lag:
            lag_state, tau = thruster_wrench(thr_cfg, lag, lag_state, u8)
        else:
            tau = thruster_wrench_nolag(thr_cfg, u8)
        return (inner(x_ext, tau), lag_state)

    return step


def simulate_with_tether(
    p,
    thr_cfg,
    lag,
    cfg: TetherConfig,
    anchor_pos,
    x0_ext,
    U,
    dt: float,
    method: str = "rk4",
    substeps: int = 40,
    use_lag: bool = True,
):
    """Open-loop rollout of the coupled system; returns ``(T+1, ...,
    12 + 6(n-1))`` with ``x0_ext`` in row 0."""
    from bluerov2_dynamics_tpu_torch.ops.integrators import rollout

    lag_state0 = torch.zeros((*x0_ext.shape[:-1], 8, 3), dtype=x0_ext.dtype,
                             device=x0_ext.device)
    step = make_coupled_step(p, thr_cfg, lag, cfg, anchor_pos, dt, method, substeps, use_lag)
    _, (traj, _) = rollout(step, (x0_ext, lag_state0), U, include_initial=True)
    return traj

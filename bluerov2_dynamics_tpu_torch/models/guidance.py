"""Waypoint guidance: lookahead-based line-of-sight (LOS) path following
(PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/guidance.py``: a waypoint list
is followed by steering the vehicle's heading at a cruise surge speed
(Fossen's lookahead-based LOS law, ``psi_d = pi_p + atan2(-e, Delta)``,
*Handbook of Marine Craft Hydrodynamics and Motion Control* ch. 10.3), with
depth interpolated along each segment and a station-keeping hold at the
final waypoint; the inner loop is the hover :class:`~.control.LQRPolicy`'s
gain.

The mission is one step loop (``ops.scan.scan``: CUDA graphs on the card).
The active waypoint index is an int32 tensor carried through the loop,
advanced by masks (acceptance-circle hit or along-track overrun) and used
by tensor indexing, never read back to the host.  Kept from the JAX
package as it behaves: the hit test uses x and y only (a waypoint that
differs from the previous one in depth alone is passed at once), and the
ILOS integrator resets on a waypoint switch and in hold.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.models.control import _leaves, _rebuild
from bluerov2_dynamics_tpu_torch.ops.rotations import ssa
from bluerov2_dynamics_tpu_torch.ops.scan import scan


# ---------------------------------------------------------------------------
# LOS geometry (pure, batch-broadcasting)
# ---------------------------------------------------------------------------

def path_tangential_angle(wp_a, wp_b):
    """Azimuth ``pi_p`` of the segment ``a -> b`` in the horizontal plane."""
    d = torch.as_tensor(wp_b)[..., :2] - torch.as_tensor(wp_a)[..., :2]
    return torch.atan2(d[..., 1], d[..., 0])


def track_errors(wp_a, wp_b, pos):
    """Along-track / cross-track errors ``(s, e)`` of ``pos`` for segment
    ``a -> b``: ``s`` the distance along the path tangent from ``a``, ``e``
    positive to the left of the path (``e = -dx sin(pi_p) + dy
    cos(pi_p)``)."""
    wp_a = torch.as_tensor(wp_a)
    pos = torch.as_tensor(pos)
    pi_p = path_tangential_angle(wp_a, wp_b)
    c, s_ = torch.cos(pi_p), torch.sin(pi_p)
    dx = pos[..., 0] - wp_a[..., 0]
    dy = pos[..., 1] - wp_a[..., 1]
    return c * dx + s_ * dy, -s_ * dx + c * dy


def los_heading(wp_a, wp_b, pos, lookahead):
    """Lookahead-based LOS heading command for segment ``a -> b``."""
    pi_p = path_tangential_angle(wp_a, wp_b)
    _, e = track_errors(wp_a, wp_b, pos)
    return ssa(pi_p + torch.atan2(-e, torch.as_tensor(lookahead, dtype=e.dtype)))


# ---------------------------------------------------------------------------
# Mission plan + closed-loop simulation
# ---------------------------------------------------------------------------

class WaypointPlan(NamedTuple):
    """A waypoint mission; ``waypoints[0]`` is the start position (the first
    active segment is ``waypoints[0] -> waypoints[1]``).  Build with
    :func:`make_plan`."""

    waypoints: torch.Tensor       # (N+1, 3) NED positions incl. start row
    accept_radius: torch.Tensor   # scalar: horizontal acceptance circle
    lookahead: torch.Tensor       # scalar: LOS lookahead distance [m]
    cruise_speed: torch.Tensor    # scalar: desired surge u_d in transit
    integral_gain: torch.Tensor   # scalar kappa: 0 = plain LOS, >0 = ILOS


def make_plan(start_pos, waypoints, accept_radius=0.15, lookahead=0.6, cruise_speed=0.25,
              integral_gain=0.0, dtype=torch.float32, device=None) -> WaypointPlan:
    """A :class:`WaypointPlan` from a start position and ``(N, 3)``
    waypoints (NED; ``N >= 1``) on ``device`` (default: the start's, or the
    CPU for host values).  ``integral_gain`` (kappa) > 0 enables integral
    LOS: the cross-track error integrates and the law steers on ``e + kappa
    e_int``."""
    if device is None and isinstance(start_pos, torch.Tensor):
        device = start_pos.device
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64) if not isinstance(  # noqa: E731
        a, torch.Tensor) else a, dtype=dtype, device=device)
    start = f(start_pos).reshape(3)
    wps = f(waypoints).reshape(-1, 3)
    return WaypointPlan(waypoints=torch.cat([start[None], wps], dim=0),
                        accept_radius=f(accept_radius), lookahead=f(lookahead),
                        cruise_speed=f(cruise_speed), integral_gain=f(integral_gain))


def _segment(plan: WaypointPlan, idx):
    """``(a, b)``: the ends of the active segment at index ``idx`` (an int
    tensor, saturated at the last segment), selected on the device."""
    n_seg = plan.waypoints.shape[0] - 1
    seg = torch.clamp(idx, max=n_seg).reshape(1).long()
    return (plan.waypoints.index_select(0, seg - 1)[0],
            plan.waypoints.index_select(0, seg)[0])


def _advance_index(plan: WaypointPlan, pos, idx):
    """Advance ``idx`` past the active target when inside its acceptance
    circle (horizontal distance) or past the segment end, saturating at
    ``n_wp`` + 1 = "hold"."""
    n_seg = plan.waypoints.shape[0] - 1
    a, b = _segment(plan, idx)
    s, _ = track_errors(a, b, pos)
    seg_len = torch.linalg.norm(b[:2] - a[:2])
    hit = torch.linalg.norm(pos[:2] - b[:2]) < plan.accept_radius
    overrun = s > seg_len
    return torch.clamp(idx + (hit | overrun).to(idx.dtype), max=n_seg + 1)


def _references(plan: WaypointPlan, x, idx, e_int):
    """Reference state, hold flag and cross-track error at waypoint index
    ``idx`` (``idx > n_seg``: hold at the final waypoint); ``e_int`` is the
    ILOS integrator."""
    n_seg = plan.waypoints.shape[0] - 1
    hold = idx > n_seg
    a, b = _segment(plan, idx)
    pos = x[:3]
    pi_p = path_tangential_angle(a, b)
    s, e = track_errors(a, b, pos)
    e_eff = e + plan.integral_gain * e_int
    psi_los = ssa(pi_p + torch.atan2(-e_eff, plan.lookahead))
    seg_len = torch.clamp(torch.linalg.norm(b[:2] - a[:2]), min=1e-6)
    frac = torch.clamp(s / seg_len, 0.0, 1.0)
    z_d = a[2] + frac * (b[2] - a[2])
    psi_d = torch.where(hold, pi_p, psi_los)
    u_d = torch.where(hold, torch.zeros_like(plan.cruise_speed), plan.cruise_speed)
    zero = torch.zeros_like(z_d)
    x_ref = torch.stack([torch.where(hold, b[0], pos[0]), torch.where(hold, b[1], pos[1]),
                         torch.where(hold, b[2], z_d), zero, zero, psi_d, u_d,
                         zero, zero, zero, zero, zero])
    return x_ref, hold, e


def _masked_error(x, x_ref, hold):
    """State error fed to the gain: angles wrapped; in transit the x/y rows
    zeroed (guidance owns the plane); in hold the horizontal position error
    rotated into the heading-aligned frame."""
    err = x - x_ref
    c, s = torch.cos(x[5]), torch.sin(x[5])
    ex, ey = err[0], err[1]
    zero = torch.zeros((), dtype=err.dtype, device=err.device)
    ex_r = torch.where(hold, c * ex + s * ey, zero)
    ey_r = torch.where(hold, -s * ex + c * ey, zero)
    return torch.cat([ex_r[None], ey_r[None], err[2:3], ssa(err[3:6]), err[6:]])


class MissionResult(NamedTuple):
    X: torch.Tensor            # (steps+1, 12) states incl. initial
    U: torch.Tensor            # (steps, 8) thruster commands
    wp_index: torch.Tensor     # (steps,) int32 active waypoint index
    cross_track: torch.Tensor  # (steps,) signed cross-track error [m]
    psi_d: torch.Tensor        # (steps,) commanded heading


def simulate_los_mission(plant_step: Callable, policy, plan: WaypointPlan, carry0, steps: int,
                         get_state: Callable = lambda c: c, dt: float = 0.02,
                         graph=None) -> MissionResult:
    """Fly a waypoint mission closed-loop: LOS guidance (outer) and the
    ``policy``'s gain (inner; its ``K``, ``u_eq`` and clip limits are used,
    the references come from the guidance) against any plant step.  ``dt``
    only feeds the ILOS integrator.  ``graph`` as ``ops.scan.use_graph``
    resolves it."""
    K, u_eq = policy.K, policy.u_eq
    dtype = plan.waypoints.dtype
    n_seg = plan.waypoints.shape[0] - 1
    x0 = get_state(carry0)
    n_leaves = len(_leaves(carry0))

    def body(c, _):
        pc, idx, e_int = _rebuild(carry0, c[:n_leaves]), c[n_leaves], c[n_leaves + 1]
        x = get_state(pc)
        idx_new = _advance_index(plan, x[:3], idx)
        # the ILOS integrator resets on a waypoint switch and in hold
        e_int = torch.where((idx_new != idx) | (idx_new > n_seg), torch.zeros_like(e_int), e_int)
        x_ref, hold, e_ct = _references(plan, x, idx_new, e_int)
        # de_int/dt = U Delta e / (Delta^2 + (e + kappa e_int)^2), frozen in hold
        e_eff = e_ct + plan.integral_gain * e_int
        rate = (plan.cruise_speed * plan.lookahead * e_ct
                / (plan.lookahead ** 2 + e_eff ** 2))
        e_int = torch.where(hold, e_int, e_int + dt * rate)
        err = _masked_error(x, x_ref, hold)
        u = torch.clamp(u_eq - err @ K.T, policy.u_lo, policy.u_hi)
        pc = plant_step(pc, u)
        return (*_leaves(pc), idx_new, e_int), (get_state(pc), u, idx_new, e_ct, x_ref[5])

    idx0 = torch.ones((), dtype=torch.int32, device=x0.device)
    e0 = torch.zeros((), dtype=dtype, device=x0.device)
    X, U, wp_idx, e_ct, psi_d = scan(body, (*_leaves(carry0), idx0, e0),
                                     (x0.new_empty((steps, 0)),), graph=graph)
    return MissionResult(torch.cat([x0[None], X]), U, wp_idx, e_ct, psi_d)


def mission_summary(result: MissionResult, plan: WaypointPlan):
    """Host-side mission metrics: per-waypoint closest horizontal approach
    and first-hit step, final position error, and the cross-track RMS over
    the transit portion (hold excluded)."""
    X = result.X.detach().cpu().numpy()
    wps = plan.waypoints.detach().cpu().numpy()[1:]          # targets only
    r = float(plan.accept_radius)
    d = np.linalg.norm(X[:, None, :2] - wps[None, :, :2], axis=-1)
    min_dist = d.min(axis=0)
    hit = d < r
    hit_step = np.where(hit.any(axis=0), hit.argmax(axis=0), -1)
    idx = result.wp_index.cpu().numpy()
    transit = idx <= len(wps)
    ct = result.cross_track.detach().cpu().numpy()[transit]
    return {
        "min_dist": min_dist,
        "hit_step": hit_step,
        "all_hit": bool(hit.any(axis=0).all()),
        "final_pos_err": float(np.linalg.norm(X[-1, :3] - wps[-1])),
        "cross_track_rms": float(np.sqrt(np.mean(ct ** 2))) if ct.size else 0.0,
    }

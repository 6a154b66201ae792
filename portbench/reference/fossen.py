"""Plain reference of the BlueROV2 heavy model, from a configuration's numbers.

Written from the published equations (Fossen's 6-DOF model with the
von Benzon et al. Table A1 coefficients), not from the port: every constant
is derived here from the configuration file (the diagonal mass matrix and
its inverse, the restoring terms, the thruster wrench map, the ZOH lag),
the Coriolis term is written as cross products, and the rows advance as
``(n, 12)`` or ``(n, 13)`` tensors.  It imports nothing of the port.

A :class:`Precision` says how it computes: ``F64`` is the reference,
``TF32`` the control, float32 arithmetic with every intermediate vector
rounded to TF32's 10-bit mantissa (the precision below the configuration's
float32 with TF32 off).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest, ties to even, at 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    rnd: Optional[Callable]

    def r(self, t):
        return t if self.rnd is None else self.rnd(t)


@contextmanager
def strict_float32():
    """Matrix products in full float32 (TF32 off) for the body."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


F64 = Precision("float64", torch.float64, None)
TF32 = Precision("tf32", torch.float32, round_tf32)

N_COEFFS = 23


def nominal_coefficients(cfg: dict) -> list:
    """The 23 identified coefficients in the fit's order: m, volume, the
    inertia diagonal, 6 added masses, 6 linear and 6 quadratic damping
    derivatives (added mass and damping negative, as published)."""
    return ([cfg["m"], cfg["volume"]] + list(cfg["inertia"]) + list(cfg["added_mass"])
            + list(cfg["damping_linear"]) + list(cfg["damping_quadratic"]))


class Hydro(NamedTuple):
    m: torch.Tensor
    inertia: torch.Tensor      # (3,)
    added: torch.Tensor        # (6,) negative derivatives
    minv: torch.Tensor         # (6,)
    d_lin: torch.Tensor        # (6,) positive
    d_quad: torch.Tensor       # (6,) positive
    W: torch.Tensor
    B: torch.Tensor
    cb: torch.Tensor           # (3,)
    current: torch.Tensor      # (3,) NED


def hydro(cfg: dict, coeffs: torch.Tensor, prec: Precision = F64) -> Hydro:
    """The model's terms from the 23 coefficients ``coeffs`` (differentiable)."""
    dev = coeffs.device
    m, vol = coeffs[0], coeffs[1]
    inertia, added = coeffs[2:5], coeffs[5:11]
    mdiag = torch.cat([m - added[0:3], inertia - added[3:6]])
    as_t = lambda v: torch.as_tensor(v, dtype=prec.dtype, device=dev)  # noqa: E731
    r = prec.r
    return Hydro(m=r(m), inertia=r(inertia), added=r(added), minv=r(1.0 / mdiag),
                 d_lin=r(-coeffs[11:17]), d_quad=r(-coeffs[17:23]), W=r(m * cfg["g"]),
                 B=r(cfg["rho"] * cfg["g"] * vol), cb=r(as_t(cfg["cb"])),
                 current=r(as_t(cfg["current_ned"])))


def nominal_hydro(cfg: dict, device, prec: Precision = F64) -> Hydro:
    return hydro(cfg, torch.tensor(nominal_coefficients(cfg), dtype=torch.float64,
                                   device=device).to(prec.dtype), prec)


# ---------------------------------------------------------------------------
# Thrusters: T200 curve, ZOH lag, wrench map
# ---------------------------------------------------------------------------

def _rz(a: float) -> torch.Tensor:
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)


def wrench_map(cfg: dict) -> torch.Tensor:
    """``(8, 6)`` rows ``[d_i ; r_i x d_i]`` (float64, host): tau = F @ map."""
    th = cfg["thrusters"]
    pos, dirs = [], []
    for i, a in enumerate(th["position_angles"]):
        arm = th["arm_horizontal"] if i < 4 else th["arm_vertical"]
        pos.append(_rz(a) @ torch.tensor(arm, dtype=torch.float64))
    for a in th["direction_angles"]:
        dirs.append(_rz(a) @ torch.tensor(th["horizontal_direction"], dtype=torch.float64))
    dirs += [torch.tensor(th["vertical_direction"], dtype=torch.float64)] * (len(pos) - len(dirs))
    pos, dirs = torch.stack(pos), torch.stack(dirs)
    return torch.cat([dirs, torch.linalg.cross(pos, dirs)], dim=1)


def zoh_lag(cfg: dict, dt: float):
    """``(Ad (3, 3), Bd (3,), c (3,))``: ``expm([[A, B], [0, 0]] dt)`` in float64."""
    lag = cfg["lag"]
    aug = torch.zeros((4, 4), dtype=torch.float64)
    aug[:3, :3] = torch.tensor(lag["A"], dtype=torch.float64)
    aug[:3, 3] = torch.tensor(lag["B"], dtype=torch.float64)
    E = torch.linalg.matrix_exp(aug * dt)
    return E[:3, :3], E[:3, 3], torch.tensor(lag["C"], dtype=torch.float64)


class Actuation(NamedTuple):
    curve: tuple               # odd-power coefficients c1, c3, ... (floats)
    Ad: torch.Tensor
    Bd: torch.Tensor
    c: torch.Tensor
    W: torch.Tensor            # (8, 6)

    def thrust(self, u):
        """Static T200 thrust of normalised commands ``u`` (Horner on u^2)."""
        u2 = u * u
        acc = torch.zeros_like(u) + self.curve[-1]
        for ck in reversed(self.curve[:-1]):
            acc = ck + u2 * acc
        return u * acc

    def step(self, L, u, prec: Precision = F64):
        """Advance the lag states ``L (..., 8, 3)`` one sample under commands
        ``u (..., 8)``; returns ``(L', tau (..., 6))``, the wrench read after
        the update."""
        F = prec.r(self.thrust(u))
        L = prec.r(L @ self.Ad.T + F[..., None] * self.Bd)
        return L, prec.r(prec.r(L @ self.c) @ self.W)


def actuation(cfg: dict, device, prec: Precision = F64) -> Actuation:
    Ad, Bd, c = zoh_lag(cfg, cfg["dt"])
    to = lambda t: prec.r(t.to(device=device, dtype=prec.dtype))  # noqa: E731
    return Actuation(tuple(cfg["thrusters"]["t200_curve_odd"]), to(Ad), to(Bd), to(c),
                     to(wrench_map(cfg)))


def effectiveness(cfg: dict) -> torch.Tensor:
    """``(8, 6)``: a quat13 recording's wrench is ``U @ effectiveness``."""
    wi = cfg["wrench_input"]
    axes = torch.tensor(wi["rotor_axes"], dtype=torch.float64)
    axes = axes / torch.linalg.norm(axes, dim=1, keepdim=True)
    pos = torch.tensor(wi["rotor_positions"], dtype=torch.float64)
    return torch.cat([axes, torch.linalg.cross(pos, axes)], dim=1)


# ---------------------------------------------------------------------------
# Rigid body
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _nu_dot(h: Hydro, nu1, nu2, v_c_body, k, tau, prec: Precision):
    """``M^-1 (tau - C(nu) nu - D(nu_r) nu_r - g)``; ``k`` is the third row of
    R_{b->n} (gravity's direction in the body frame)."""
    a1 = -h.added[0:3] * nu1                     # added-mass momenta
    a2 = -h.added[3:6] * nu2
    C = prec.r(torch.cat([h.m * _cross(nu2, nu1) + _cross(nu2, a1),
                          _cross(nu2, h.inertia * nu2) + _cross(nu1, a1) + _cross(nu2, a2)],
                         dim=-1))
    nu_r = torch.cat([nu1 - v_c_body, nu2], dim=-1)
    D = prec.r((h.d_lin + h.d_quad * nu_r.abs()) * nu_r)
    g = prec.r(torch.cat([-(h.W - h.B) * k, h.B * _cross(h.cb.expand_as(k), k)], dim=-1))
    return prec.r((tau - C - D - g) * h.minv)


def rhs_euler12(h: Hydro, x, tau, prec: Precision = F64):
    """``x_dot`` of ``x = [x, y, z, phi, theta, psi, u, v, w, p, q, r]`` (n, 12)."""
    sf, cf = torch.sin(x[:, 3]), torch.cos(x[:, 3])
    st, ct = torch.sin(x[:, 4]), torch.cos(x[:, 4])
    sp, cp = torch.sin(x[:, 5]), torch.cos(x[:, 5])
    R = prec.r(torch.stack([
        torch.stack([cp * ct, -sp * cf + cp * st * sf, sp * sf + cp * cf * st], -1),
        torch.stack([sp * ct, cp * cf + sf * st * sp, -cp * sf + st * sp * cf], -1),
        torch.stack([-st, ct * sf, ct * cf], -1)], -2))             # R_{b->n}
    nu1, nu2 = x[:, 6:9], x[:, 9:12]
    v_c = torch.einsum("nji,j->ni", R, h.current)
    nu_dot = _nu_dot(h, nu1, nu2, v_c, R[:, 2, :], tau, prec)
    p, q, r = nu2[:, 0], nu2[:, 1], nu2[:, 2]
    a = q * sf + r * cf
    eul = prec.r(torch.stack([p + a * st / ct, q * cf - r * sf, a / ct], -1))
    pos = prec.r(torch.einsum("nij,nj->ni", R, nu1))
    return torch.cat([pos, eul, nu_dot], dim=-1)


def normalize_quat(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rhs_quat13(h: Hydro, x, tau, prec: Precision = F64):
    """``x_dot`` of ``x = [x, y, z, qw, qx, qy, qz, u, v, w, p, q, r]`` (n, 13);
    the quaternion is normalised on entry."""
    qt = prec.r(normalize_quat(x[:, 3:7]))
    w, a, b, c = qt[:, 0], qt[:, 1], qt[:, 2], qt[:, 3]
    R = prec.r(torch.stack([
        torch.stack([1 - 2 * (b * b + c * c), 2 * (a * b - c * w), 2 * (a * c + b * w)], -1),
        torch.stack([2 * (a * b + c * w), 1 - 2 * (a * a + c * c), 2 * (b * c - a * w)], -1),
        torch.stack([2 * (a * c - b * w), 2 * (b * c + a * w), 1 - 2 * (a * a + b * b)], -1)], -2))
    nu1, nu2 = x[:, 7:10], x[:, 10:13]
    v_c = torch.einsum("nji,j->ni", R, h.current)
    nu_dot = _nu_dot(h, nu1, nu2, v_c, R[:, 2, :], tau, prec)
    p, q, r = nu2[:, 0], nu2[:, 1], nu2[:, 2]
    q_dot = prec.r(0.5 * torch.stack([-a * p - b * q - c * r, w * p + b * r - c * q,
                                      w * q - a * r + c * p, w * r + a * q - b * p], -1))
    pos = prec.r(torch.einsum("nij,nj->ni", R, nu1))
    return torch.cat([pos, q_dot, nu_dot], dim=-1)


def make_step(cfg: dict, h: Hydro, method: str, prec: Precision = F64):
    """``step(x, tau) -> x'``: one Euler or RK4 step of the configuration's
    state convention with the wrench held across it (quat13: renormalised
    after the step where the configuration says so)."""
    rhs = {"euler12": rhs_euler12, "quat13": rhs_quat13}[cfg["state"]]
    dt = cfg["dt"]
    renorm = cfg["state"] == "quat13" and cfg.get("renormalize", False)

    def f(x, tau):
        return rhs(h, x, tau, prec)

    def step(x, tau):
        if method == "euler":
            x = prec.r(x + dt * f(x, tau))
        elif method == "rk4":
            k1 = f(x, tau)
            k2 = f(prec.r(x + 0.5 * dt * k1), tau)
            k3 = f(prec.r(x + 0.5 * dt * k2), tau)
            k4 = f(prec.r(x + dt * k3), tau)
            x = prec.r(x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))
        else:
            raise ValueError(f"unknown method {method!r}")
        if renorm:
            x = torch.cat([x[:, 0:3], prec.r(normalize_quat(x[:, 3:7])), x[:, 7:]], dim=-1)
        return x

    return step

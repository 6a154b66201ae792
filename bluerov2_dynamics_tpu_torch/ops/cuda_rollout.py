"""K1: the shared-input euler12 rollout, as a CUDA kernel and its plain
PyTorch version.

Replaces ``ops/pallas_rollout.py::make_rollout_final_pallas`` of the JAX
package (and the ``lax.scan`` ``shared_tau_sequence`` that feeds it): B
starts advance T Euler or RK4 steps under one command sequence ``U (T, 8)``
and only the final states ``(B, 12)`` are returned.

* ``csrc/rollout.cu`` holds the rollout, one thread per start with its 12
  states in registers for all T steps, and the prologue that turns ``U``
  into the per-step wrench ``tau_seq (T, 6)`` (curve, lag, wrench map).
  The rollout is bound by operations on the H100 (~684 flops, 8 divisions
  and 12 exact sincosf per RK4 step; x0, xT and U are its only traffic).
  The prologue runs a chunk of 256 steps on a block's 8 warps, one
  thruster a warp and 8 steps a lane, with the lanes' lag maps combined by
  a warp-shuffle scan; the main path runs it inside K1 itself, so
  ``U -> xT`` is one C call and one launch
  (:func:`launch_rollout_from_commands`).  Block size and launches are
  constants of the source, by measurement; :func:`rollout_occupancy` and
  :func:`rollout_commands_occupancy` report them with the resident blocks
  per SM.
* The plain version is the row form of the JAX kernel body
  (``make_hydro_rows`` / ``make_rhs_rows`` / ``rk4_rows``: the state is a
  12-tuple of ``(B,)`` tensors and every coefficient a Python float), with
  the same association order as the kernel; the prologue's is
  :func:`shared_tau_sequence_chunked`, in the kernel's chunked order.  The
  CPU tests hold them against the Pallas kernel in interpret mode and the
  ``lax.scan``; ``chip_smoke.py`` holds the kernels against them on the
  card.

The wrappers dispatch on the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ThrusterConfig,
)
from bluerov2_dynamics_tpu_torch.models.thrusters import (
    lag_history_chunked,
    lag_step,
    static_thrust,
    wrench_from_thrust,
)
from bluerov2_dynamics_tpu_torch.ops import _build

METHODS = {"euler": 0, "rk4": 1}
_F = ctypes.c_float


class RowConsts(ctypes.Structure):
    """Mirror of ``struct RowConsts`` in ``csrc/fossen_rows.cuh``."""

    _fields_ = [
        ("mdiag", _F * 6), ("minv", _F * 6), ("gyro", _F * 3),
        ("yz", _F), ("zx", _F), ("xy", _F),
        ("d_lin", _F * 6), ("d_quad", _F * 6),
        ("WB", _F), ("xbB", _F), ("ybB", _F), ("zbB", _F),
        ("cur", _F * 3),
        ("dt", _F), ("half_dt", _F), ("sixth_dt", _F),
    ]


class ThrusterConsts(ctypes.Structure):
    """Mirror of ``struct ThrusterConsts`` in ``csrc/fossen_rows.cuh``."""

    _fields_ = [("curve", _F * 5), ("Ad", _F * 9), ("Bd", _F * 3),
                ("c", _F * 3), ("Wm", _F * 48)]


def host_float_groups(*ts) -> list:
    """The stored values of each tensor of ``ts`` as a list of Python
    floats (exact in float64), read back to the host in one copy: one
    ``torch.cat`` of the flattened tensors on their device, then one
    ``.cpu()``."""
    flat = [float(v) for v in torch.cat([t.detach().reshape(-1) for t in ts]).cpu().tolist()]
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()])
        i += t.numel()
    return out


def _hydro_floats(p: FossenParams) -> dict:
    """The row form's coefficients as Python floats; combinations of stored
    values (``Yvd - Zwd``, ``W - B``, ``zb * B``...) are formed in float64
    and round once where they meet a float32 tensor, as the JAX kernels'
    baked Python floats do."""
    added, mdiag, minv, gyro, d_lin, d_quad, cb, cur, (W,), (Bf,) = host_float_groups(
        p.added, p.mdiag, p.minv, p.gyro, p.d_lin, p.d_quad, p.cb, p.current.expand(3), p.W,
        p.B)
    Xud, Yvd, Zwd = added[0], added[1], added[2]
    xb, yb, zb = cb
    return dict(
        mdiag=mdiag, minv=minv, gyro=gyro,
        yz=Yvd - Zwd, zx=Zwd - Xud, xy=Xud - Yvd,
        d_lin=d_lin, d_quad=d_quad,
        WB=W - Bf, xbB=xb * Bf, ybB=yb * Bf, zbB=zb * Bf,
        cur=cur,
    )


def row_consts(p: FossenParams, dt: float) -> RowConsts:
    """Kernel constants of the row step, read back in one copy; ``0.5 dt``
    and ``dt / 6`` are formed in float64 and rounded once."""
    h = _hydro_floats(p)
    k = RowConsts()
    for name in ("mdiag", "minv", "gyro", "d_lin", "d_quad", "cur"):
        getattr(k, name)[:] = h[name]
    for name in ("yz", "zx", "xy", "WB", "xbB", "ybB", "zbB"):
        setattr(k, name, h[name])
    k.dt, k.half_dt, k.sixth_dt = dt, 0.5 * dt, dt / 6.0
    return k


def thruster_consts(cfg: ThrusterConfig, lag: LagParams) -> ThrusterConsts:
    """Kernel constants of the actuation, read back in one copy."""
    c = ThrusterConsts()
    c.curve[:], c.Ad[:], c.Bd[:], c.c[:], c.Wm[:] = host_float_groups(
        cfg.curve, lag.Ad, lag.Bd, lag.c, cfg.wrench_map)
    return c


# ---------------------------------------------------------------------------
# Plain version: the row form
# ---------------------------------------------------------------------------

def shared_tau_sequence(cfg: ThrusterConfig, lag: LagParams, U, use_lag: bool = True):
    """Exact per-step body wrench ``(T, 6)`` for a shared command sequence
    ``U (T, 8)``: the lag filter advanced once per step from rest, as in
    ``make_thruster_step``.  Plain PyTorch (a loop over T)."""
    cfg, lag = cfg.to(U.device), lag.to(U.device)
    F_cmd = static_thrust(cfg, U)
    if not use_lag:
        return wrench_from_thrust(cfg, F_cmd)
    state = torch.zeros((8, 3), dtype=U.dtype, device=U.device)
    F = []
    for t in range(U.shape[0]):
        state, F_t = lag_step(lag, state, F_cmd[t])
        F.append(F_t)
    F = torch.stack(F) if F else F_cmd
    return wrench_from_thrust(cfg, F)


# csrc/rollout.cu: kTauChunk steps a chunk of the prologue, kLanes lanes
# (one warp) a thruster's lag scan
TAU_CHUNK, TAU_LANES = 256, 32


def shared_tau_sequence_chunked(cfg: ThrusterConfig, lag: LagParams, U, use_lag: bool = True,
                                chunk: int = TAU_CHUNK, lanes: int = TAU_LANES):
    """The wrench sequence ``(T, 6)`` of :func:`shared_tau_sequence` in the
    kernel's association order: the lag states of
    ``thrusters.lag_history_chunked`` (the lane scan over chunks of
    ``chunk`` steps), each advanced by its step's thrust and read out.
    Plain PyTorch (a loop over chunks)."""
    cfg, lag = cfg.to(U.device), lag.to(U.device)
    F_cmd = static_thrust(cfg, U)
    if not use_lag:
        return wrench_from_thrust(cfg, F_cmd)
    state = torch.zeros((8, 3), dtype=U.dtype, device=U.device)
    F = []
    for t in range(U.shape[0]):
        state, F_t = lag_step(lag, state, F_cmd[t])
        F.append(F_t)
    F = torch.stack(F) if F else F_cmd
    return wrench_from_thrust(cfg, F)


# csrc/rollout.cu: kTauChunk steps a chunk of the prologue, kLanes lanes
# (one warp) a thruster's lag scan
TAU_CHUNK, TAU_LANES = 256, 32


def shared_tau_sequence_chunked(cfg: ThrusterConfig, lag: LagParams, U, use_lag: bool = True,
                                chunk: int = TAU_CHUNK, lanes: int = TAU_LANES):
    """The wrench sequence ``(T, 6)`` of :func:`shared_tau_sequence` in the
    kernel's association order: for each chunk of ``chunk`` steps, each of
    ``lanes`` lanes runs its ``chunk // lanes`` steps from rest (lane 0
    from the chunk's start state); an inclusive scan combines the lanes'
    maps ``x -> P x + e`` (``P = Ad^(chunk // lanes)`` by squaring, level
    ``s`` adding ``P^(2^s)`` times the lane ``2^s`` before); each lane then
    reruns its steps from the end state of the lane before it, and the last
    lane's end state starts the next chunk (the states of
    ``thrusters.lag_history_chunked``).  ``chunk`` and ``lanes`` are powers
    of two.  Plain PyTorch (a loop over chunks)."""
    cfg, lag = cfg.to(U.device), lag.to(U.device)
    F_cmd = static_thrust(cfg, U)
    if not use_lag:
        return wrench_from_thrust(cfg, F_cmd)
    hist = lag_history_chunked(lag, F_cmd, chunk, lanes)
    _, F = lag_step(lag, hist, F_cmd)
    return wrench_from_thrust(cfg, F)


def make_hydro_rows(p: FossenParams):
    """Hydrodynamics shared by the row RHSs: ``hydro(R, nu, tau) ->
    ((px, py, pz), (nd0..nd5))`` with ``R`` the 9 entries of R_{b->n}
    (row-major) and ``nu`` the six body velocities, each a ``(B,)`` tensor.
    A zero current skips the relative-velocity terms (``u - 0`` is exact,
    so the kernel's single path gives the same numbers)."""
    h = _hydro_floats(p)
    mdiag, minv, gyro = h["mdiag"], h["minv"], h["gyro"]
    d_lin, d_quad = h["d_lin"], h["d_quad"]
    yz, zx, xy = h["yz"], h["zx"], h["xy"]
    WB, xbB, ybB, zbB = h["WB"], h["xbB"], h["ybB"], h["zbB"]
    cnx, cny, cnz = h["cur"]
    has_current = any(c != 0.0 for c in h["cur"])

    def hydro(R, nu, tau):
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
        u, v, w, pp, q, r = nu

        c0 = mdiag[2] * w * q - mdiag[1] * v * r
        c1 = -mdiag[2] * w * pp + mdiag[0] * u * r
        c2 = mdiag[1] * v * pp - mdiag[0] * u * q
        c3 = gyro[0] * q * r + yz * v * w
        c4 = gyro[1] * pp * r + zx * u * w
        c5 = gyro[2] * pp * q + xy * u * v

        if has_current:
            ur = u - (r00 * cnx + r10 * cny + r20 * cnz)
            vr = v - (r01 * cnx + r11 * cny + r21 * cnz)
            wr = w - (r02 * cnx + r12 * cny + r22 * cnz)
        else:
            ur, vr, wr = u, v, w
        d0 = (d_lin[0] + d_quad[0] * torch.abs(ur)) * ur
        d1 = (d_lin[1] + d_quad[1] * torch.abs(vr)) * vr
        d2 = (d_lin[2] + d_quad[2] * torch.abs(wr)) * wr
        d3 = (d_lin[3] + d_quad[3] * torch.abs(pp)) * pp
        d4 = (d_lin[4] + d_quad[4] * torch.abs(q)) * q
        d5 = (d_lin[5] + d_quad[5] * torch.abs(r)) * r

        sth = -r20
        g0 = WB * sth
        g1 = -WB * r21
        g2 = -WB * r22
        g3 = ybB * r22 - zbB * r21
        g4 = -zbB * sth - xbB * r22
        g5 = xbB * r21 + ybB * sth

        nd0 = (tau[0] - c0 - d0 - g0) * minv[0]
        nd1 = (tau[1] - c1 - d1 - g1) * minv[1]
        nd2 = (tau[2] - c2 - d2 - g2) * minv[2]
        nd3 = (tau[3] - c3 - d3 - g3) * minv[3]
        nd4 = (tau[4] - c4 - d4 - g4) * minv[4]
        nd5 = (tau[5] - c5 - d5 - g5) * minv[5]

        px = r00 * u + r01 * v + r02 * w
        py = r10 * u + r11 * v + r12 * w
        pz = r20 * u + r21 * v + r22 * w
        return (px, py, pz), (nd0, nd1, nd2, nd3, nd4, nd5)

    return hydro


def make_rhs_rows(p: FossenParams):
    """Closed-form euler12 RHS on a 12-tuple of ``(B,)`` rows, ocean current
    included; ``tau`` is a 6-sequence of scalars or ``(B,)`` rows."""
    hydro = make_hydro_rows(p)

    def rhs(x, tau):
        phi, theta, psi = x[3], x[4], x[5]
        nu = (x[6], x[7], x[8], x[9], x[10], x[11])
        pp, q, r = nu[3], nu[4], nu[5]

        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(theta), torch.sin(theta)
        cpsi, spsi = torch.cos(psi), torch.sin(psi)

        R = (
            cpsi * cth,
            -spsi * cphi + cpsi * sth * sphi,
            spsi * sphi + cpsi * cphi * sth,
            spsi * cth,
            cpsi * cphi + sphi * sth * spsi,
            -cpsi * sphi + sth * spsi * cphi,
            -sth,
            cth * sphi,
            cth * cphi,
        )
        (px, py, pz), nd = hydro(R, nu, tau)

        eps = 1e-7
        one = torch.ones_like(cth)
        sign = torch.where(cth < 0.0, -one, one)
        cth_c = torch.where(torch.abs(cth) < eps, eps * sign, cth)
        tth = sth / cth_c
        dphi = pp + sphi * tth * q + cphi * tth * r
        dtheta = cphi * q - sphi * r
        dpsi = (sphi * q + cphi * r) / cth_c
        return (px, py, pz, dphi, dtheta, dpsi) + nd

    return rhs


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; use 'euler' or 'rk4'")


def rk4_rows(rhs, xs, tau, dt, method):
    """One integrator step on the 12-tuple row state."""
    check_method(method)
    if method == "euler":
        k1 = rhs(xs, tau)
        return tuple(x + dt * k for x, k in zip(xs, k1))
    k1 = rhs(xs, tau)
    k2 = rhs(tuple(x + (0.5 * dt) * k for x, k in zip(xs, k1)), tau)
    k3 = rhs(tuple(x + (0.5 * dt) * k for x, k in zip(xs, k2)), tau)
    k4 = rhs(tuple(x + dt * k for x, k in zip(xs, k3)), tau)
    return tuple(
        x + (dt / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(xs, k1, k2, k3, k4)
    )


def rollout_rows_plain(p: FossenParams, tau_seq, x0, dt: float, method: str = "rk4"):
    """Final states ``(B, 12)`` of ``x0 (B, 12)`` after ``len(tau_seq)``
    steps under the per-step wrench ``tau_seq (T, 6)``."""
    check_method(method)
    rhs = make_rhs_rows(p)
    xs = tuple(x0.unbind(-1))
    for t in range(tau_seq.shape[0]):
        xs = rk4_rows(rhs, xs, tuple(tau_seq[t].unbind()), dt, method)
    return torch.stack(xs, dim=-1)


def rollout_final_plain(p: FossenParams, cfg: ThrusterConfig, lag: LagParams,
                        x0, U, dt: float, method: str = "rk4", use_lag: bool = True):
    """Plain PyTorch version of K1: ``x0 (B, 12)``, ``U (T, 8)`` -> ``(B, 12)``,
    its wrench sequence in the kernel's chunked order."""
    tau_seq = shared_tau_sequence_chunked(cfg, lag, U.to(torch.float32), use_lag)
    return rollout_rows_plain(p, tau_seq, x0, dt, method)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_kernel_input(t, name: str, width: int) -> None:
    """Raise on what the kernels do not take: a non-CUDA, non-float32,
    non-contiguous or wrongly shaped tensor."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != width:
        raise ValueError(f"{name} must be (N, {width}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(*ts) -> bool:
    return len({t.device for t in ts}) == 1


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_tau_seq(consts: ThrusterConsts, U, use_lag: bool = True):
    """Launch the prologue kernel alone: ``tau_seq (T, 6)`` from ``U (T, 8)``,
    in the order of :func:`shared_tau_sequence_chunked`."""
    check_kernel_input(U, "U", 8)
    lib = _build.load_library("rollout")
    T = U.shape[0]
    tau = torch.empty((T, 6), dtype=torch.float32, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.brov2_tau_seq(ctypes.addressof(consts), U.data_ptr(), None, tau.data_ptr(), T,
                               int(use_lag), _stream(U))
    _build.check(lib, rc, "shared_tau")
    _build.launches["shared_tau"] += 1
    return tau


def rollout_occupancy(method: str = "rk4") -> tuple:
    """``(block, resident blocks per SM)`` of K1 as it launches (the CUDA
    occupancy query)."""
    check_method(method)
    lib = _build.load_library("rollout")
    block, n = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.brov2_rollout_occupancy(METHODS[method], ctypes.byref(block),
                                                  ctypes.byref(n)), "rollout occupancy")
    return block.value, n.value


def rollout_commands_occupancy(method: str = "rk4") -> tuple:
    """``(block, resident blocks per SM)`` of the K1 kernel with the
    prologue folded in, which :func:`launch_rollout_from_commands` launches
    (the CUDA occupancy query)."""
    check_method(method)
    lib = _build.load_library("rollout")
    block, n = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.brov2_rollout_commands_occupancy(
        METHODS[method], ctypes.byref(block), ctypes.byref(n)), "rollout_from_commands occupancy")
    return block.value, n.value


def launch_rollout_from_commands(rc: RowConsts, tc: ThrusterConsts, U, x0, method: str,
                                 use_lag: bool = True, tau=None):
    """K1 from the commands, ``x0 (B, 12)`` and ``U (T, 8)`` -> ``xT (B, 12)``:
    one C call, one launch.  The prologue runs inside K1 and writes
    ``tau_seq`` into ``tau (T, 6)`` where one is given.  Counts one launch
    of K1; the prologue kernel is not launched."""
    check_method(method)
    check_kernel_input(x0, "x0", 12)
    check_kernel_input(U, "U", 8)
    if tau is not None:
        check_kernel_input(tau, "tau", 6)
    if not same_device(x0, U, *(() if tau is None else (tau,))):
        raise ValueError("x0, U and tau must be on one device")
    B, T = x0.shape[0], U.shape[0]
    if tau is not None and tau.shape[0] != T:
        raise ValueError(f"tau must be ({T}, 6), got {tuple(tau.shape)}")
    out = torch.empty_like(x0)
    if B == 0 and tau is None:
        return out
    lib = _build.load_library("rollout")
    with torch.cuda.device(x0.device):
        code = lib.brov2_rollout_from_commands(
            ctypes.addressof(rc), ctypes.addressof(tc), U.data_ptr(), x0.data_ptr(),
            out.data_ptr(), None if tau is None else tau.data_ptr(), B, T, METHODS[method],
            int(use_lag), _stream(x0))
    _build.check(lib, code, "rollout_from_commands")
    _build.launches["rollout_final"] += 1
    return out


def launch_rollout(consts: RowConsts, tau_seq, x0, method: str):
    """Launch K1 on ``x0 (B, 12)`` under ``tau_seq (T, 6)``."""
    check_method(method)
    check_kernel_input(x0, "x0", 12)
    check_kernel_input(tau_seq, "tau_seq", 6)
    if not same_device(x0, tau_seq):
        raise ValueError("x0 and tau_seq must be on one device")
    out = torch.empty_like(x0)
    B, T = x0.shape[0], tau_seq.shape[0]
    if B == 0:
        return out
    lib = _build.load_library("rollout")
    with torch.cuda.device(x0.device):
        rc = lib.brov2_rollout_final(ctypes.addressof(consts), tau_seq.data_ptr(),
                                     x0.data_ptr(), out.data_ptr(), B, T,
                                     METHODS[method], _stream(x0))
    _build.check(lib, rc, "rollout_final")
    _build.launches["rollout_final"] += 1
    return out


def make_rollout_final_cuda(
    p: FossenParams,
    cfg: ThrusterConfig,
    lag: LagParams,
    dt: float,
    method: str = "rk4",
    use_lag: bool = True,
):
    """Build ``fn(x0, U) -> xT``: ``x0 (B, 12)``, shared commands
    ``U (T, 8)``.  The constants are read once here; any B and T work (the
    ragged edges are masked in the kernel).  On CUDA tensors one C call
    makes the whole ``U -> xT`` sequence (:func:`launch_rollout_from_commands`)."""
    check_method(method)
    rc, tc = row_consts(p, dt), thruster_consts(cfg, lag)

    def fn(x0, U):
        if not same_device(x0, U):
            raise ValueError(f"x0 and U on different devices ({x0.device}, {U.device})")
        if x0.device.type == "cpu":
            return rollout_final_plain(p, cfg, lag, x0, U, dt, method, use_lag)
        return launch_rollout_from_commands(rc, tc, U, x0, method, use_lag)

    return fn


def rollout_final_cuda(p, cfg, lag, x0, U, dt: float, method: str = "rk4",
                       use_lag: bool = True):
    """One-shot convenience wrapper around :func:`make_rollout_final_cuda`."""
    return make_rollout_final_cuda(p, cfg, lag, dt, method, use_lag)(x0, U)

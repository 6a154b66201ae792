"""Differentiable Fossen parameter identification (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/sysid.py``.  The multi-step
prediction error of the full nonlinear model is differentiated end to end
through the integrator (autograd through the step loop, the thruster map
and the ZOH lag filter included) and minimised with Adam over 23 log-scale
factors on the Table A1 coefficients (mass, displaced volume, inertia
diagonal, 6 added-mass, 6 linear-damping, 6 quadratic-damping), optionally
8 per-thruster log-gains and a constant NED current.

All ``N - H`` window starts advance together as one batch; inner step t
reads the contiguous slices ``U[t + d : t + d + n_start]`` and scores
against ``X[t + 1 : t + 1 + n_start]`` (no gathers).  On CUDA one Adam
iteration (loss, backward, update) is captured once as a CUDA graph and
replayed ``steps`` times, the step count and bias corrections on the
device and no read-back inside the loop: the twin of the JAX fit being one
compiled call.  The eager loop is the CPU path and the plain version the
graph is held against.  A thruster fit by Euler in that graph takes its
loss and gradient from one CUDA kernel (``csrc/sysid_window.cu``, through
:class:`_KernelWindowLoss`) in place of autograd's thousands of launches;
the autograd loss of :func:`thruster_loss` is its plain version, and stays
the loss of every other path.  The lag warm start, the filter states over
the whole recording, is one launch of ``csrc/lag_history.cu`` on the card
(:func:`lag_history`).  With ``mesh=`` each rank takes its contiguous
block of starts and the ranks all-reduce the loss and the gradients, so
the objective stays the global mean; that path runs eagerly.

The Laplace standard errors take the Hessian of the same window loss by
``torch.func.hessian`` (forward over reverse, as ``jax.hessian``); the
eigen-decomposition and the rule for dead directions run in float64 numpy
on the host.  Every function the loss reaches is therefore functional: no
in-place op, no read-back and no branch on a tensor's value.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models import fossen
from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ThrusterConfig,
    lag_params,
    thruster_config,
)
from bluerov2_dynamics_tpu_torch.models.thrusters import lag_history_chunked, static_thrust
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import check_aligned
from bluerov2_dynamics_tpu_torch.ops.cuda_rollout import (
    check_kernel_input,
    host_float_groups,
    thruster_consts,
)
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.ops.scan import capture, use_graph
from bluerov2_dynamics_tpu_torch.utils.profiling import span

# Nominal Table A1 coefficient vector in the generator's perturbation
# layout (``data/synthetic.py::perturbed_fossen_params``):
# [m, volume, Ix, Iy, Iz, added(6), damping_lin(6), damping_quad(6)].
NOMINAL_COEFFS = (
    13.5, 0.0134,
    0.26, 0.23, 0.37,
    -6.36, -7.12, -18.68, -0.189, -0.135, -0.222,
    -13.7, -0.0, -33.0, -0.0, -0.8, -0.0,
    -141.0, -217.0, -190.0, -1.19, -0.47, -1.5,
)

# SNAME-notation labels for the 23 coefficients, same order.
COEFF_NAMES = (
    "m", "V",
    "Ix", "Iy", "Iz",
    "Xud", "Yvd", "Zwd", "Kpd", "Mqd", "Nrd",
    "Xu", "Yv", "Zw", "Kp", "Mq", "Nr",
    "Xuu", "Yvv", "Zww", "Kpp", "Mqq", "Nrr",
)

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GRAPH_WARMUP = 3            # iterations run on a side stream before the capture
RHO, GRAVITY = 1000.0, 9.82     # water density [kg/m^3], gravity [m/s^2]


def params_from_scales(
    scales,
    rho: float = RHO,
    g: float = GRAVITY,
    cb=(0.0, 0.0, -0.01),
    current=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    device=None,
) -> FossenParams:
    """:class:`FossenParams` from 23 coefficient scales, differentiable in
    ``scales`` (and in ``current`` where it is a tensor).

    The derived fields (``mdiag``, ``minv``, ``gyro``, ``W``, ``B``) are
    formed in ``dtype`` on the scales' device, in the JAX package's order;
    ``params_from_scales(torch.ones(23))`` equals ``fossen_params()``.
    """
    if device is None and isinstance(scales, torch.Tensor):
        device = scales.device
    s = torch.as_tensor(scales, dtype=dtype, device=device)
    if s.shape != (23,):
        raise ValueError(f"scales must have shape (23,), got {tuple(s.shape)}")
    k = _Consts.make(dtype, s.device, cb, current)
    return _assemble(k.nominal * s, k.cb, k.current, rho, g)


class _Consts(NamedTuple):
    """The builder's constant tensors, made once on the fit's device (a
    CUDA graph cannot capture their copies from the host)."""

    nominal: torch.Tensor
    cb: torch.Tensor
    current: torch.Tensor

    @staticmethod
    def make(dtype, device, cb=(0.0, 0.0, -0.01), current=(0.0, 0.0, 0.0)) -> "_Consts":
        return _Consts(torch.as_tensor(NOMINAL_COEFFS, dtype=dtype, device=device),
                       torch.as_tensor(cb, dtype=dtype, device=device),
                       torch.as_tensor(current, dtype=dtype, device=device))


def _assemble(c, cb, current, rho: float = RHO, g: float = GRAVITY) -> FossenParams:
    """:class:`FossenParams` from the 23 scaled coefficients ``c``."""
    m = c[0]
    volume = c[1]
    inertia = c[2:5]
    added = c[5:11]
    d_lin = -c[11:17]
    d_quad = -c[17:23]
    mdiag = torch.cat([m - added[0:3], inertia - added[3:6]])
    gyro = torch.stack([
        inertia[2] - inertia[1] + added[4] - added[5],
        inertia[0] - inertia[2] + added[5] - added[3],
        inertia[1] - inertia[0] + added[3] - added[4],
    ])
    return FossenParams(
        m=m,
        W=m * g,
        B=rho * g * volume,
        cb=cb,
        inertia=inertia,
        added=added,
        d_lin=d_lin,
        d_quad=d_quad,
        mdiag=mdiag,
        minv=1.0 / mdiag,
        gyro=gyro,
        current=current,
    )


class SysidResult(NamedTuple):
    """Result of a differentiable parameter fit; every tensor detached."""

    params: FossenParams                 # fitted coefficients
    cfg: Optional[ThrusterConfig]        # thruster config incl. fitted gains (thruster fits)
    log_scales: torch.Tensor             # (23,) fitted log-scale factors
    log_gains: Optional[torch.Tensor]    # (8,) fitted per-thruster log-gains or None
    losses: torch.Tensor                 # (steps,) training-loss history
    current: Optional[torch.Tensor] = None   # (3,) fitted NED current [m/s] or None
    stderr: Optional[dict] = None        # per-parameter Laplace stderr (keys of theta)


def _window_loss(step, carry0, get_state, X, U, horizon: int, n_start: int,
                 input_delay: int = 0, block=None):
    """Mean squared multi-step prediction error over the window starts.

    At inner step t every start k has advanced t+1 steps from X[k] under
    ``U[k + t + input_delay]``; its prediction is scored against
    ``X[k + t + 1]``.  ``block = (lo, n)`` runs only starts ``lo .. lo+n-1``
    (one rank's share) and returns their part of the global mean: squared
    errors summed and divided by the global count, so that the ranks' parts
    add up to the whole.
    """
    lo, n = (0, n_start) if block is None else block
    count = n_start * X.shape[-1]
    carry = carry0
    errs = []
    for t in range(horizon):
        u0 = lo + t + input_delay
        carry = step(carry, U[u0:u0 + n])
        d = get_state(carry) - X[lo + t + 1:lo + t + 1 + n]
        errs.append(torch.mean(d * d) if block is None else torch.sum(d * d) / count)
    errs = torch.stack(errs)
    return torch.mean(errs) if block is None else torch.sum(errs) / horizon


def lag_history(cfg: ThrusterConfig, lag: LagParams, U):
    """Per-sample lag-filter states ``(N, 8, 3)`` over a recording.

    Entry ``k`` is the filter state *before* consuming ``U[k]``, from
    at-rest filters at the start of the recording: the state the thrusters
    carried when command ``U[k]`` was issued (this is not the wrench
    history of ``thrusters.effective_wrench_history``).  The filter input
    is the static-curve thrust of the command, independent of the vehicle
    state and of every fitted coefficient, so the history is computed once
    a fit.  A window that starts its lag from zero carries a thrust error
    for the filter's ~0.3 s settling time, which a gradient fit would bend
    the coefficients to absorb.  On a CUDA tensor the scan is one launch
    of ``csrc/lag_history.cu`` (float32 or float64); on the CPU its plain
    version, ``thrusters.lag_history_chunked``.  The call is the span
    ``brov2.sysid.lag_history`` in a profiler's trace.
    """
    with span("brov2.sysid.lag_history"):
        F_cmd = static_thrust(cfg, U)
        if F_cmd.is_cuda:
            return _launch_lag_history(lag, F_cmd)
        return lag_history_chunked(lag, F_cmd)


def _launch_lag_history(lag: LagParams, F_cmd):
    """One launch of ``csrc/lag_history.cu`` on the current stream: the
    history ``(N, 8, 3)`` of the thrusts ``F_cmd``, with ``lag.Ad`` and
    ``lag.Bd`` read on the device (no read-back, no synchronise).  Raises
    on what the kernel does not take: another device or type than
    ``F_cmd``'s, a type other than float32 or float64, a shape other than
    ``(N, 8)``, ``(3, 3)`` and ``(3,)``, a non-contiguous tensor."""
    if F_cmd.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"F_cmd must be float32 or float64, got {F_cmd.dtype}")
    for name, t, shape in (("F_cmd", F_cmd, (F_cmd.shape[0], 8)), ("Ad", lag.Ad, (3, 3)),
                           ("Bd", lag.Bd, (3,))):
        if t.dtype != F_cmd.dtype:
            raise TypeError(f"{name} must be {F_cmd.dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != F_cmd.device:
            raise ValueError(f"{name} must be on {F_cmd.device}, got {t.device}")
    if not F_cmd.is_cuda:
        raise ValueError(f"F_cmd must be a CUDA tensor, got {F_cmd.device}")
    hist = torch.empty((F_cmd.shape[0], 8, 3), dtype=F_cmd.dtype, device=F_cmd.device)
    lib = _build.load_library("lag_history")
    with torch.cuda.device(F_cmd.device):
        code = lib.brov2_lag_history(
            lag.Ad.data_ptr(), lag.Bd.data_ptr(), F_cmd.data_ptr(), hist.data_ptr(),
            F_cmd.shape[0], int(F_cmd.dtype == torch.float64),
            torch.cuda.current_stream(F_cmd.device).cuda_stream)
    _build.check(lib, code, "lag_history")
    _build.launches["lag_history"] += 1
    return hist


def _flat(theta: dict, names) -> torch.Tensor:
    return torch.cat([theta[k].reshape(-1) for k in names])


def _unflat(flat, like: dict, names) -> dict:
    parts = flat.split([like[k].numel() for k in names])
    return {k: v.view_as(like[k]) for k, v in zip(names, parts)}


def adam_update(theta: list, grads: list, mu: list, nu: list, count, lr: float) -> None:
    """One ``optax.adam(lr)`` step, in place and in optax's order: ``count
    += 1``; ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu + (1 - b2) g^2``
    (as ``(1 - b) g^k + b m``); the bias corrections ``1 - b^count`` in
    float64 on ``count``'s device, cast to the moments' dtype; ``update =
    mu_hat / (sqrt(nu_hat) + eps)`` (``eps_root`` 0); ``theta += -lr *
    update``.  ``count`` is a 0-d float64 tensor, so that no value leaves
    the device."""
    b1, b2 = ADAM_B1, ADAM_B2
    with torch.no_grad():
        count.add_(1.0)
        bc1, bc2 = 1 - torch.pow(b1, count), 1 - torch.pow(b2, count)
        for t, g, m, v in zip(theta, grads, mu, nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            update = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + ADAM_EPS)
            t.add_(-lr * update)


def _run_adam(loss_fn: Callable, theta0: dict, steps: int, lr: float,
              graph: bool = False, reduce: Optional[Callable] = None,
              warmup: int = GRAPH_WARMUP, stats: Optional[dict] = None):
    """Full-batch Adam over ``steps`` iterations: returns ``(theta, losses
    (steps,))``, the loss of each iteration at the parameters it starts
    from.  ``graph``: capture one iteration as a CUDA graph
    (``ops.scan.capture``) and replay it; otherwise the eager loop.
    ``reduce(flat)`` sums the loss and the gradients over the ranks of a
    mesh (eager only).  ``warmup``
    iterations run on a side stream before the capture (their state
    changes are undone).  A ``stats`` dict receives, on the graph path, the
    host seconds of the warm-up and capture (``"capture_s"``) and the
    device milliseconds an iteration replayed (``"replay_ms"``, CUDA events
    around the replays); with ``stats["keep"]`` set, the captured
    iteration's replay (``"replay"``), to trace it.  In a profiler's trace
    the graph path's warm-up and capture are the span
    ``brov2.sysid.capture`` and its replays, synchronise included,
    ``brov2.sysid.replay``."""
    names = sorted(theta0)
    theta = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
    leaves = [theta[k] for k in names]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    first = leaves[0]
    count = torch.zeros((), dtype=torch.float64, device=first.device)
    hist = torch.empty(steps, dtype=first.dtype, device=first.device)

    def iteration():
        loss = loss_fn(theta)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if reduce is not None:
            flat = reduce(torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads]))
            loss = flat[0]
            grads = [g.view_as(t) for g, t in zip(
                flat[1:].split([t.numel() for t in leaves]), leaves)]
        adam_update(leaves, grads, mu, nu, count, lr)
        return loss

    with full_f32():
        if not graph:
            for i in range(steps):
                hist[i] = iteration()
        elif steps > 0:
            state = leaves + mu + nu + [count]
            with span("brov2.sysid.capture"):
                t_start = time.perf_counter()
                (run,) = capture([iteration], state, True, warmup=warmup)
                t_captured = time.perf_counter()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with span("brov2.sysid.replay"):
                events[0].record()
                for i in range(steps):
                    hist[i].copy_(run())
                events[1].record()
                torch.cuda.current_stream(first.device).synchronize()
            if stats is not None:
                stats["capture_s"] = t_captured - t_start
                stats["replay_ms"] = events[0].elapsed_time(events[1]) / steps
                if stats.pop("keep", False):
                    stats["replay"] = run
    return {k: v.detach() for k, v in theta.items()}, hist


def _laplace_stderr(loss_fn: Callable, theta: dict, n_resid: int,
                    reduce: Optional[Callable] = None) -> dict:
    """Gauss-Newton / Laplace standard errors at the fitted optimum.

    ``torch.func.hessian`` of the mean-squared window loss through the step
    loop, then ``cov = (2 L* / N) H^{-1}`` with the residual MSE ``L*`` as
    the noise-variance estimate.  Directions of (near-)zero curvature, such
    as the scales on zero-valued nominal coefficients, whose gradients
    vanish identically, are reported as ``inf`` (unidentifiable).  The
    teacher-forced windows overlap, so the residuals are correlated and the
    stderrs are optimistic in absolute terms; their relative ordering is
    the useful output.  ``reduce`` sums the Hessian and the loss over the
    ranks of a mesh.  Returns float32 tensors keyed as ``theta``.
    """
    names = sorted(theta)
    flat = _flat(theta, names).detach()
    with full_f32():
        H = torch.func.hessian(lambda v: loss_fn(_unflat(v, theta, names)))(flat)
        L = loss_fn(theta).detach()
        if reduce is not None:
            both = reduce(torch.cat([L.reshape(1), H.reshape(-1)]))
            L, H = both[0], both[1:].view_as(H)
    L = float(L)
    H = H.double().cpu().numpy()
    H = (H + H.T) / 2.0
    diag = np.diag(H).copy()
    w, V = np.linalg.eigh(H)
    tol = max(float(w.max()), 0.0) * 1e-9
    inv_w = np.where(w > tol, 1.0 / np.where(w > tol, w, 1.0), 0.0)
    cov = (V * inv_w) @ V.T * (2.0 * max(L, 0.0) / max(n_resid, 1))
    se = np.sqrt(np.maximum(np.diag(cov), 0.0))
    dead = diag <= max(float(diag.max()), 0.0) * 1e-12
    se = np.where(dead, np.inf, se)
    return _unflat(torch.as_tensor(se, dtype=torch.float32, device=flat.device), theta, names)


def _mesh_block(mesh, n_start: int):
    """``((lo, n), reduce)`` of this rank's contiguous block of starts, or
    ``(None, None)`` without a mesh; the mesh's first axis is used."""
    if mesh is None:
        return None, None
    import torch.distributed as dist

    from bluerov2_dynamics_tpu_torch.parallel.mesh import axis
    from bluerov2_dynamics_tpu_torch.parallel.sharded import _block

    group, size, index = axis(mesh, mesh.mesh_dim_names[0])
    lo, hi = _block(n_start, size, index)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        return flat

    return (lo, hi - lo), reduce


def _device_of(X, device):
    """A tensor's own device unless ``device`` is given; else ``device``
    (``None`` means ``cuda``)."""
    if device is None and isinstance(X, torch.Tensor):
        return X.device
    return resolve_device(device)


def _check_delay_and_starts(N: int, horizon: int, input_delay: int) -> int:
    if input_delay not in (0, 1):
        raise ValueError(f"input_delay must be 0 or 1, got {input_delay}")
    n_start = N - horizon - input_delay
    if n_start <= 0:
        raise ValueError(f"horizon {horizon} >= dataset length {N}")
    return n_start


def _scaled_params(theta: dict, k: _Consts) -> FossenParams:
    return _assemble(k.nominal * torch.exp(theta["s"]), k.cb, theta.get("c", k.current))


def _gained(cfg: ThrusterConfig, log_gains) -> ThrusterConfig:
    return cfg._replace(wrench_map=cfg.wrench_map * torch.exp(log_gains)[:, None])


class SysidConsts(ctypes.Structure):
    """Mirror of ``struct SysidConsts`` in ``csrc/sysid_adjoint.cuh``."""

    _fields_ = [("nominal", ctypes.c_float * 23), ("cb", ctypes.c_float * 3),
                ("g", ctypes.c_float), ("rho_g", ctypes.c_float), ("dt", ctypes.c_float)]


def _kernel_window(X, U, lag0, cfg: ThrusterConfig, lag: LagParams, dt: float, horizon: int,
                   n_start: int, input_delay: int, use_lag: bool, k: _Consts) -> Callable:
    """The launcher of ``csrc/sysid_window.cu`` over all ``n_start`` starts
    of :func:`thruster_loss` (Euler; ``lag0`` the lag's contiguous
    ``(n_start, 8, 3)`` warm start, None for rest): ``launch(s, g, c) ->
    (loss, grad)``, the 0-d float32 loss and the (34,) gradient (23
    log-scales, then 8 log-gains and 3 current components where ``g`` and
    ``c`` are given, else None).  Checks the inputs, reads the constants
    back and allocates the scratch once; each call allocates its two
    outputs and launches once."""
    check_kernel_input(X, "X", 12)
    check_kernel_input(U, "U", 8)
    check_aligned(U, "U", 16)
    lib = _build.load_library("sysid_window")
    plan = (ctypes.c_int * 7)()     # [6]: the partials' doubles, with gains and current
    _build.check(lib, lib.brov2_sysid_window_plan(int(use_lag), 1, 1, n_start, horizon, plan),
                 "sysid_window plan")
    sc = SysidConsts()
    sc.nominal[:], sc.cb[:] = host_float_groups(k.nominal, k.cb)
    sc.g, sc.rho_g, sc.dt = GRAVITY, RHO * GRAVITY, dt
    tc = thruster_consts(cfg, lag)
    partials = torch.empty(plan[6], dtype=torch.float64, device=X.device)
    ticket = torch.zeros((), dtype=torch.int32, device=X.device)     # zero between launches
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def launch(s, g, c):
        loss = torch.empty((), dtype=torch.float32, device=X.device)
        grad = torch.empty(34, dtype=torch.float32, device=X.device)
        with torch.cuda.device(X.device):
            code = lib.brov2_sysid_window(
                ctypes.addressof(sc), ctypes.addressof(tc), s.data_ptr(), ptr(g), ptr(c),
                X.data_ptr(), U.data_ptr(), ptr(lag0), loss.data_ptr(), grad.data_ptr(),
                partials.data_ptr(), partials.numel(), ticket.data_ptr(), n_start, horizon,
                input_delay, int(use_lag), torch.cuda.current_stream(X.device).cuda_stream)
        _build.check(lib, code, "sysid_window")
        _build.launches["sysid_window"] += 1
        return loss, grad

    return launch


class _KernelWindowLoss(torch.autograd.Function):
    """The window loss from one launch of ``csrc/sysid_window.cu``, which
    computes the gradient in the same launch; the backward scales that
    gradient by ``grad_output``.  ``launch`` is :func:`_kernel_window`'s."""

    @staticmethod
    def forward(ctx, launch, s, g, c):
        loss, grad = launch(s, g, c)
        ctx.save_for_backward(grad)
        ctx.fitted = (g is not None, c is not None)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        (grad,) = ctx.saved_tensors
        scaled = grad_output * grad
        gains, current = ctx.fitted
        return (None, scaled[:23], scaled[23:31] if gains else None,
                scaled[31:34] if current else None)


class WindowLoss(NamedTuple):
    """A fit's objective: ``loss_fn(theta) -> 0-d tensor`` and its
    starting point ``theta0`` (a dict of ``"s"``, 23 log-scales; ``"g"``, 8
    log-gains; ``"c"``, 3 current components), the global start count, the
    mesh's ``reduce`` (or None) and, for the thruster model, the thruster
    configuration and lag it runs with."""

    loss_fn: Callable
    theta0: dict
    n_start: int
    reduce: Optional[Callable]
    cfg: Optional[ThrusterConfig] = None
    lag: Optional[LagParams] = None


def thruster_loss(X, U, dt: float, horizon: int = 10, **kw) -> WindowLoss:
    """The window loss of :func:`fit_thruster` under its keywords from
    ``method`` to ``device``, validated as it validates its inputs; with
    ``mesh`` this rank's block of starts."""
    return _thruster_loss(X, U, dt, horizon, False, **kw)[0]


def _thruster_loss(X, U, dt: float, horizon: int, kernel: bool, *, method: str = "euler",
                   use_lag: bool = True, lag_warmup: bool = True, fit_gains: bool = False,
                   fit_current: bool = False, input_delay: int = 0,
                   cfg: Optional[ThrusterConfig] = None, lag: Optional[LagParams] = None,
                   mesh=None, dtype=torch.float32,
                   device=None) -> tuple[WindowLoss, Optional[Callable]]:
    """:func:`thruster_loss`, and with ``kernel`` the same loss from
    ``csrc/sysid_window.cu`` (Euler, float32, one CUDA device; ``loss_fn``
    is its plain version), else None."""
    device = _device_of(X, device)
    cfg = (cfg if cfg is not None else thruster_config(dtype=dtype, device=device)).to(device)
    lag = (lag if lag is not None else lag_params(dt, dtype=dtype, device=device)).to(device)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    U = torch.as_tensor(U, dtype=dtype, device=device)
    if X.ndim != 2 or X.shape[1] != 12:
        raise ValueError(f"X must be (N, 12), got {tuple(X.shape)}")
    if U.shape[0] != X.shape[0] or U.ndim != 2 or U.shape[1] != 8:
        raise ValueError(f"U must be ({X.shape[0]}, 8), got {tuple(U.shape)}")
    n_start = _check_delay_and_starts(X.shape[0], horizon, input_delay)
    block, reduce = _mesh_block(mesh, n_start)

    theta0 = {"s": torch.zeros(23, dtype=dtype, device=device)}
    if fit_gains:
        theta0["g"] = torch.zeros(8, dtype=dtype, device=device)
    if fit_current:
        theta0["c"] = torch.zeros(3, dtype=dtype, device=device)
    k = _Consts.make(dtype, device)
    lo, n = (0, n_start) if block is None else block
    x0 = X[lo:lo + n]
    if use_lag and lag_warmup:
        lag0 = lag_history(cfg, lag, U)[input_delay + lo:input_delay + lo + n]
    else:
        lag0 = torch.zeros((n, 8, 3), dtype=dtype, device=device)

    def loss_fn(theta):
        p = _scaled_params(theta, k)
        c = _gained(cfg, theta["g"]) if fit_gains else cfg
        step = fossen.make_thruster_step(p, c, lag, dt, method, use_lag)
        return _window_loss(step, (x0, lag0), lambda carry: carry[0], X, U, horizon, n_start,
                            input_delay, block)

    kernel_fn = None
    if kernel:
        if not _takes_kernel(method, True, mesh, dtype) or device.type != "cuda":
            raise ValueError("the window-loss kernel runs Euler in float32 on one CUDA device")
        launch = _kernel_window(X, U, lag0 if use_lag and lag_warmup else None, cfg, lag, dt,
                                horizon, n_start, input_delay, use_lag, k)

        def kernel_fn(theta):
            return _KernelWindowLoss.apply(launch, theta["s"], theta.get("g"), theta.get("c"))

    return WindowLoss(loss_fn, theta0, n_start, reduce, cfg, lag), kernel_fn


def wrench_loss(X, TAU, dt: float, horizon: int = 10, *, method: str = "euler",
                state: str = "euler12", fit_current: bool = False, input_delay: int = 0,
                mesh=None, dtype=torch.float32, device=None) -> WindowLoss:
    """The window loss of :func:`fit_wrench`, validated as it validates
    its inputs; with ``mesh`` this rank's block of starts."""
    n_state = {"euler12": 12, "quat13": 13}.get(state)
    if n_state is None:
        raise ValueError(f"unknown state convention {state!r}")
    device = _device_of(X, device)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    TAU = torch.as_tensor(TAU, dtype=dtype, device=device)
    if X.ndim != 2 or X.shape[1] != n_state:
        raise ValueError(f"X must be (N, {n_state}) for {state}, got {tuple(X.shape)}")
    if TAU.shape[0] != X.shape[0] or TAU.ndim != 2 or TAU.shape[1] != 6:
        raise ValueError(f"TAU must be ({X.shape[0]}, 6), got {tuple(TAU.shape)}")
    n_start = _check_delay_and_starts(X.shape[0], horizon, input_delay)
    block, reduce = _mesh_block(mesh, n_start)

    k = _Consts.make(dtype, device)
    lo, n = (0, n_start) if block is None else block
    x0 = X[lo:lo + n]
    theta0 = {"s": torch.zeros(23, dtype=dtype, device=device)}
    if fit_current:
        theta0["c"] = torch.zeros(3, dtype=dtype, device=device)

    def loss_fn(theta):
        step = fossen.make_wrench_step(_scaled_params(theta, k), dt, method, state)
        return _window_loss(step, x0, lambda carry: carry, X, TAU, horizon, n_start,
                            input_delay, block)

    return WindowLoss(loss_fn, theta0, n_start, reduce)


def _takes_kernel(method: str, use_graph: bool, mesh, dtype) -> bool:
    """Whether a thruster fit takes its loss from the window-loss kernel:
    Euler, float32, in the CUDA graph of one device.  RK4, a mesh, the
    eager loop and float64 keep the autograd loss."""
    return method == "euler" and use_graph and mesh is None and dtype == torch.float32


def fit_thruster(
    X,
    U,
    dt: float,
    horizon: int = 10,
    steps: int = 300,
    lr: float = 0.02,
    *,
    method: str = "euler",
    use_lag: bool = True,
    lag_warmup: bool = True,
    fit_gains: bool = False,
    fit_current: bool = False,
    compute_stderr: bool = False,
    input_delay: int = 0,
    cfg: Optional[ThrusterConfig] = None,
    lag: Optional[LagParams] = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    graph: Optional[bool] = None,
) -> SysidResult:
    """Fit the 23 Table A1 coefficients of the thruster-input model.

    ``X``: ``(N, 12)`` recorded euler12 states, ``U``: ``(N, 8)`` thruster
    commands (the T2/T5/T6 dataset contract), on the device of ``X`` when
    it is a tensor, else on ``device`` (``None`` means ``cuda``).
    ``fit_gains`` also learns 8 per-thruster gain factors (scaling the
    wrench-map rows); ``fit_current`` a constant ambient NED current (3
    additive parameters, m/s).  The lag filter runs as the evaluator runs
    it (per-start state, advanced once a step), warm-started per window
    from :func:`lag_history` when ``lag_warmup``.

    ``input_delay``: which command drives the step from X[k]: 0 pairs it
    with U[k] (the evaluator convention, right for real recordings), 1
    with U[k+1] (the generated recordings, which record each command next
    to the state it produced).  ``mesh`` (first axis used) splits the
    window starts over the ranks.  ``graph`` (default: on CUDA without a
    mesh) runs the fit as a replayed CUDA graph of one iteration; by Euler
    in float32 that iteration takes the loss and its gradient from one
    kernel (``csrc/sysid_window.cu``), else from autograd.
    """
    device = _device_of(X, device)
    graph = use_graph(graph, device, mesh)
    kernel = _takes_kernel(method, graph, mesh, dtype)
    wl, kernel_fn = _thruster_loss(
        X, U, dt, horizon, kernel, method=method, use_lag=use_lag, lag_warmup=lag_warmup,
        fit_gains=fit_gains, fit_current=fit_current, input_delay=input_delay, cfg=cfg,
        lag=lag, mesh=mesh, dtype=dtype, device=device)
    theta, losses = _run_adam(kernel_fn or wl.loss_fn, wl.theta0, steps, lr, graph, wl.reduce)
    stderr = None
    if compute_stderr:
        stderr = _laplace_stderr(wl.loss_fn, theta, horizon * wl.n_start * 12, wl.reduce)
    log_gains = theta.get("g")
    return SysidResult(
        params=_scaled_params(theta, _Consts.make(dtype, device)),
        cfg=_gained(wl.cfg, log_gains) if fit_gains else wl.cfg,
        log_scales=theta["s"],
        log_gains=log_gains,
        losses=losses,
        current=theta.get("c"),
        stderr=stderr,
    )


def fit_wrench(
    X,
    TAU,
    dt: float,
    horizon: int = 10,
    steps: int = 300,
    lr: float = 0.02,
    *,
    method: str = "euler",
    state: str = "euler12",
    fit_current: bool = False,
    compute_stderr: bool = False,
    input_delay: int = 0,
    mesh=None,
    dtype=torch.float32,
    device=None,
    graph: Optional[bool] = None,
) -> SysidResult:
    """Fit the 23 coefficients of a wrench-input model (euler12 or quat13).

    ``X``: ``(N, 12)`` or ``(N, 13)`` states matching ``state``; ``TAU``:
    ``(N, 6)`` recorded body wrenches (the T3/T4 dataset contract).  The
    quat13 step renormalises the quaternion after every step, as the
    apps' evaluator does.  ``fit_current``, ``input_delay``, ``mesh``,
    ``device`` and ``graph`` as in :func:`fit_thruster`.
    """
    device = _device_of(X, device)
    wl = wrench_loss(X, TAU, dt, horizon, method=method, state=state, fit_current=fit_current,
                     input_delay=input_delay, mesh=mesh, dtype=dtype, device=device)
    theta, losses = _run_adam(wl.loss_fn, wl.theta0, steps, lr,
                              use_graph(graph, device, mesh), wl.reduce)
    stderr = None
    if compute_stderr:
        n_state = 12 if state == "euler12" else 13
        stderr = _laplace_stderr(wl.loss_fn, theta, horizon * wl.n_start * n_state, wl.reduce)
    return SysidResult(
        params=_scaled_params(theta, _Consts.make(dtype, device)),
        cfg=None,
        log_scales=theta["s"],
        log_gains=None,
        losses=losses,
        current=theta.get("c"),
        stderr=stderr,
    )

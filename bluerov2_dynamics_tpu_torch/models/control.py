"""Model-based control on the framework's dynamics models (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/control.py``:

* :func:`trim` — the hover thruster command, by Adam on the squared state
  derivative of the lag-free step;
* :func:`linearize` — the exact discrete-time Jacobians of any step;
* :func:`dlqr` — discrete LQR by the Riccati iteration;
* :func:`koopman_dlqr` — LQR on the lifted linear system of a fitted
  EDMDc model;
* :func:`simulate_closed_loop` — a state-feedback policy against any plant;
* :func:`simulate_lqg` — output feedback, an EKF in the loop;
* :func:`simulate_adaptive_koopman_lqr` — Koopman-LQR that refits its
  lifted model, re-trims and re-solves its gains every segment;
* :func:`simulate_mpc` — receding-horizon MPC, Adam through the horizon
  rollout at every plant step;
* :func:`simulate_mppi` — sampling-based MPC (MPPI), the sampled plans one
  batch, optionally split over the ranks of a mesh;
* :func:`ilqr` / :func:`simulate_tvlqr` — iterative LQR and the execution of
  its plan with the backward pass' time-varying gains;
* :func:`trajopt` — Adam over a squashed control sequence through the
  rollout.

A plant's ``carry`` is a tensor or a tuple of tensors, as in the JAX package
(the thruster plant's is ``(x, lag_state)``); ``ilqr``, ``simulate_tvlqr``
and ``simulate_lqg`` work on the carry flattened as ``ravel_pytree``
flattens it (:class:`Flat`: the leaves in order, each row-major).

**Loops on the card.**  Nothing in a step reads a value back to the host, so
every loop runs as replays of CUDA graphs there (``graph=None`` picks by
device; the CPU runs the same functions eagerly, the plain version): the
closed loops, the LQG loop and the Riccati iteration through
``ops.scan.scan``; ``trim``'s and ``trajopt``'s Adam through
``sysid._run_adam``; MPC's Adam iteration and its plant step, an MPPI
sampling round and its plant step, an iLQR sweep and an adaptive segment
each as one captured function (``ops.scan.capture``) replayed on static
buffers.  Solves of symmetric positive definite systems are Cholesky
factorisations that give NaN on failure (``estimation._chol``), as JAX's
``solve(assume_a="pos")`` does: iLQR's safeguard depends on that NaN.

**Random draws.**  The LQG measurement noise, the MPPI samples and the
adaptive dither come from a ``torch.Generator`` on the data's device seeded
from ``(seed, tag)`` (:func:`stream`), not from threefry; each function also
takes its standard-normal draws as an argument (``normals=``), which is how
the tests feed it the JAX package's own.  The draws are made outside the
captured graphs, in the same order on both paths.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from bluerov2_dynamics_tpu_torch.models import fossen, koopman, sysid
from bluerov2_dynamics_tpu_torch.models.estimation import (
    _chol,
    _cho_solve,
    _cho_solve_vec,
    _jac,
    _predict,
    _update,
)
from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    ThrusterConfig,
    lag_params,
    thruster_config,
)
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.ops.scan import capture, scan, use_graph

# stream tags of the draws
LQG_TAG, MPPI_TAG, ADAPTIVE_TAG = 21, 22, 23


def stream(seed: int, tag: int, device) -> torch.Generator:
    """The generator of the draws tagged ``tag`` for ``seed`` on ``device``."""
    words = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed((int(words[0]) << 32) | int(words[1]))


# ---------------------------------------------------------------------------
# Carries, flattening
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensors of a carry (a tensor, or nested tuples of them), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _rebuild(like, leaves):
    """``like``'s structure holding ``leaves`` in place of its tensors."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        parts = [go(c) for c in t]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)

    return go(like)


class Flat(NamedTuple):
    """A carry's flattening, ``jax.flatten_util.ravel_pytree``'s order: the
    leaves in order, each row-major.  ``ravel`` and ``unravel`` take leading
    batch dimensions."""

    like: object
    shapes: tuple

    @staticmethod
    def of(carry) -> "Flat":
        return Flat(carry, tuple(tuple(t.shape) for t in _leaves(carry)))

    def ravel(self, carry):
        leaves = _leaves(carry)
        batch = leaves[0].shape[:leaves[0].ndim - len(self.shapes[0])]
        return torch.cat([t.reshape(*batch, -1) for t in leaves], dim=-1)

    def unravel(self, s):
        sizes = [int(np.prod(sh)) for sh in self.shapes]
        parts = torch.split(s, sizes, dim=-1)
        return _rebuild(self.like, [p.reshape(*s.shape[:-1], *sh)
                                    for p, sh in zip(parts, self.shapes)])


def _steps(n: int, like):
    """Empty per-step inputs of a scan that takes none."""
    return like.new_empty((n, 0))


def _repeat(f: Callable, x, n: int, graph: Optional[bool]):
    """``f`` applied ``n`` times to the tensor ``x``: the plain loop, or
    through ``ops.scan.scan``'s CUDA graphs (``graph`` as it resolves it)."""
    if not use_graph(graph, x.device):
        for _ in range(n):
            x = f(x)
        return x

    def body(c, _):
        y = f(c[0])
        return (y,), (y,)

    (ys,) = scan(body, (x,), (_steps(n, x),), graph=True)
    return ys[-1]


# ---------------------------------------------------------------------------
# Trim (hover equilibrium)
# ---------------------------------------------------------------------------

def trim(p: FossenParams, cfg: Optional[ThrusterConfig] = None, x_eq=None, steps: int = 400,
         lr: float = 0.05, dtype=torch.float32, graph: Optional[bool] = None,
         stats: Optional[dict] = None):
    """Thruster command ``u_eq`` that holds ``x_eq`` stationary: Adam
    (``sysid._run_adam``) on ``||rhs(x_eq, u)||^2`` through the lag-free
    Euler step (the lag filter's DC gain is one, so the command trims the
    lag plant in steady state).  Runs on ``p``'s device.  Returns ``(u_eq,
    residual_norm)``."""
    dev = p.m.device
    cfg = cfg if cfg is not None else thruster_config(dtype=dtype, device=dev)
    lag = lag_params(0.02, dtype=dtype, device=dev)   # unused on the lag-free path
    x_eq = (torch.zeros(12, dtype=dtype, device=dev) if x_eq is None
            else torch.as_tensor(x_eq, dtype=dtype, device=dev))
    dt = 0.02
    step = fossen.make_thruster_step(p, cfg, lag, dt, "euler", use_lag=False)
    lag0 = torch.zeros((8, 3), dtype=dtype, device=dev)

    def resid(u):
        x1, _ = step((x_eq, lag0), u)
        return (x1 - x_eq) / dt

    theta, _ = sysid._run_adam(lambda th: torch.sum(resid(th["u"]) ** 2),
                               {"u": torch.zeros(8, dtype=dtype, device=dev)}, steps, lr,
                               graph=use_graph(graph, dev), warmup=1, stats=stats)
    u = theta["u"]
    with torch.no_grad():
        return u, torch.linalg.norm(resid(u))


# ---------------------------------------------------------------------------
# Linearization + discrete LQR
# ---------------------------------------------------------------------------

def linearize(step: Callable, x_eq, u_eq):
    """Exact Jacobians ``(A, B)`` of ``x' = step(x, u)`` at an equilibrium,
    by reverse mode (``estimation._jac``)."""
    n = x_eq.shape[-1]
    A, _ = _jac(lambda x, u: step(x, u), x_eq, n, u_eq)
    B, _ = _jac(lambda u, x: step(x, u), u_eq, n, x_eq)
    return A, B


def _riccati_gain(A, B, Q, R, iters: int, graph: Optional[bool] = False):
    """The Riccati iteration shared by :func:`dlqr` and the adaptive loop,
    every GEMM in full float32 (no TF32), the JAX package's HIGHEST
    precision.  ``graph`` as ``ops.scan.use_graph`` resolves it (``False``
    inside a function that is itself captured).  Returns ``(K, P)``."""
    with full_f32():
        def body(P):
            BtP = B.T @ P
            S = R + BtP @ B
            K = _cho_solve(_chol(S), BtP @ A)
            P_new = Q + A.T @ P @ A - A.T @ P @ B @ K
            return (P_new + P_new.T) / 2.0

        P = _repeat(body, Q, iters, graph)
        BtP = B.T @ P
        K = _cho_solve(_chol(R + BtP @ B), BtP @ A)
    return K, P


def dlqr(A, B, Q, R, iters: int = 500, graph: Optional[bool] = None):
    """Infinite-horizon discrete LQR gain by ``iters`` Riccati iterations
    ``P <- Q + A^T (P - P B (R + B^T P B)^-1 B^T P) A``; returns ``(K, P)``
    for the policy ``u = -K x``.  On the card the iteration replays CUDA
    graphs."""
    A = torch.as_tensor(A)
    B = torch.as_tensor(B, dtype=A.dtype, device=A.device)
    Q = torch.as_tensor(Q, dtype=A.dtype, device=A.device)
    R = torch.as_tensor(R, dtype=A.dtype, device=A.device)
    return _riccati_gain(A, B, Q, R, iters, graph)


class LQRPolicy(NamedTuple):
    """``u(x) = clip(u_eq - K (phi(x) - z_ref), lo, hi)``."""

    K: torch.Tensor
    z_ref: torch.Tensor
    u_eq: torch.Tensor
    u_lo: float
    u_hi: float
    phi: Optional[Callable] = None   # state lift; None = identity

    def __call__(self, x):
        z = x if self.phi is None else self.phi(x)
        u = self.u_eq - (z - self.z_ref) @ self.K.T
        return torch.clamp(u, self.u_lo, self.u_hi)


def fossen_lqr(p: FossenParams, cfg: Optional[ThrusterConfig] = None, dt: float = 0.02,
               x_ref=None, Q=None, R=None, iters: int = 500, dtype=torch.float32,
               graph: Optional[bool] = None) -> LQRPolicy:
    """Hover-stabilizing LQR for the thruster-input BlueROV2: :func:`trim`
    at ``x_ref``, :func:`linearize` the lag-free Euler step, :func:`dlqr`.
    Default costs: unit state weights, 0.1 on controls.  Runs on ``p``'s
    device."""
    dev = p.m.device
    cfg = cfg if cfg is not None else thruster_config(dtype=dtype, device=dev)
    x_ref = (torch.zeros(12, dtype=dtype, device=dev) if x_ref is None
             else torch.as_tensor(x_ref, dtype=dtype, device=dev))
    Q = (torch.eye(12, dtype=dtype, device=dev) if Q is None
         else torch.as_tensor(Q, dtype=dtype, device=dev))
    R = (0.1 * torch.eye(8, dtype=dtype, device=dev) if R is None
         else torch.as_tensor(R, dtype=dtype, device=dev))
    u_eq, _ = trim(p, cfg, x_ref, dtype=dtype, graph=graph)
    nolag = fossen.make_thruster_step(p, cfg, lag_params(dt, dtype=dtype, device=dev), dt,
                                      "euler", use_lag=False)
    lag0 = torch.zeros((8, 3), dtype=dtype, device=dev)
    A, B = linearize(lambda x, u: nolag((x, lag0), u)[0], x_ref, u_eq)
    K, _ = dlqr(A, B, Q, R, iters, graph)
    return LQRPolicy(K=K, z_ref=x_ref, u_eq=u_eq, u_lo=-1.0, u_hi=1.0)


def _lifted_costs(n: int, d: int, r: int, Q, R, dtype, device):
    """``(Q_lift, R)``: the state cost embedded through the ``[I 0]``
    readout, ``C^T Q C``, and the control cost (defaults: I and 0.1 I)."""
    Q = (torch.eye(n, dtype=dtype, device=device) if Q is None
         else torch.as_tensor(Q, dtype=dtype, device=device))
    R = (0.1 * torch.eye(r, dtype=dtype, device=device) if R is None
         else torch.as_tensor(R, dtype=dtype, device=device))
    Q_lift = torch.zeros((d, d), dtype=dtype, device=device)
    Q_lift[:n, :n] = Q
    return Q_lift, R


def koopman_dlqr(model: koopman.KoopmanModel, x_ref, u_eq=None, Q=None, R=None,
                 iters: int = 500, u_limit: float = 1.0,
                 graph: Optional[bool] = None) -> LQRPolicy:
    """LQR on the lifted linear system of a fitted EDMDc model, the state
    cost on the physical readout ``x = C z`` (``Q_lift = C^T Q C``),
    regulating to ``z_ref = phi(x_ref)``."""
    n, d, r = model.state_dim, model.lift_dim, model.B.shape[1]
    dtype, dev = model.A.dtype, model.A.device
    Q_lift, R = _lifted_costs(n, d, r, Q, R, dtype, dev)
    K, _ = dlqr(model.A, model.B, Q_lift, R, iters, graph)
    x_ref = torch.as_tensor(x_ref, dtype=dtype, device=dev)
    u_eq = (torch.zeros(r, dtype=dtype, device=dev) if u_eq is None
            else torch.as_tensor(u_eq, dtype=dtype, device=dev))
    return LQRPolicy(K=K, z_ref=koopman.lift(model, x_ref), u_eq=u_eq, u_lo=-u_limit,
                     u_hi=u_limit, phi=lambda x: koopman.lift(model, x))


# ---------------------------------------------------------------------------
# Closed loop
# ---------------------------------------------------------------------------

def simulate_closed_loop(plant_step: Callable, policy: Callable, carry0, steps: int,
                         get_state: Callable = lambda c: c, graph: Optional[bool] = None):
    """Roll the plant under a state-feedback policy; returns ``(X, U)``,
    ``X`` ``(steps+1, n)`` including the initial state, ``U`` ``(steps,
    r)``."""
    x0 = get_state(carry0)

    def body(c, _):
        carry = _rebuild(carry0, c)
        u = policy(get_state(carry))
        carry = plant_step(carry, u)
        return tuple(_leaves(carry)), (get_state(carry), u)

    X, U = scan(body, _leaves(carry0), (_steps(steps, x0),), graph=graph)
    return torch.cat([x0[None], X]), U


# ---------------------------------------------------------------------------
# Output feedback (LQG: EKF in the loop)
# ---------------------------------------------------------------------------

class LQGResult(NamedTuple):
    """Closed-loop output-feedback trace: the TRUE plant states, the
    filter's estimates the policy acted on, the commands, the noisy
    measurements, the innovation diagnostics and the final posterior
    covariance over the flattened carry (or the filter's own belief)."""

    X: torch.Tensor       # (steps+1, n) true states
    X_est: torch.Tensor   # (steps+1, n) posterior estimates
    U: torch.Tensor       # (steps, r) applied commands
    Y: torch.Tensor       # (steps+1, m) measurements
    nis: torch.Tensor     # (steps+1,)
    loglik: torch.Tensor  # ()
    cov: torch.Tensor     # (ns, ns) final covariance


def _cov(M, dim: int, dtype, device):
    M = torch.as_tensor(M, dtype=dtype, device=device)
    if M.ndim == 0:
        return M * torch.eye(dim, dtype=dtype, device=device)
    if M.ndim == 1:
        return torch.diag(M)
    return M


def simulate_lqg(plant_step: Callable, policy: Callable, h: Callable, Q, R, carry0,
                 steps: int, seed: int = 0, normals=None, m0=None, P0=None,
                 get_state: Callable = lambda c: c, residual: Optional[Callable] = None,
                 model_step: Optional[Callable] = None, model_state: Optional[Callable] = None,
                 model_h: Optional[Callable] = None,
                 graph: Optional[bool] = None) -> LQGResult:
    """Output-feedback control: an EKF in the loop feeds the policy its
    state estimate; the true plant advances and a noisy measurement ``y =
    h(x) + N(0, R)`` is drawn at every step.

    The filter state is the flattened plant carry (:class:`Flat`), its
    predict/update the offline EKF's (``estimation._predict``/``_update``:
    first an update with ``Y[0]``, then predict/update).  ``Q``/``R``/
    ``P0`` may be scalars, vectors (diagonals) or matrices; ``m0``/``P0``
    default to the true flattened ``carry0`` and ``1e-2 I``.
    ``model_step(m, u)``, ``model_state(m)`` and ``model_h(m)`` run the
    filter on its own model (Koopman-LQG: the lifted ``z``), and then
    ``m0`` is required.  The measurement noise is ``chol(R)`` times
    standard normals: ``normals`` ``(steps+1, m)``, or draws of
    :func:`stream` ``(seed, LQG_TAG)`` on the carry's device (the first
    row, then ``ops.scan``'s chunks).
    """
    flat = Flat.of(carry0)
    s0 = flat.ravel(carry0)
    dtype, dev = s0.dtype, s0.device
    x0 = get_state(carry0)
    m_dim = h(x0).shape[0]

    def step_s(s, u):
        return flat.ravel(plant_step(flat.unravel(s), u))

    if model_step is None:
        if m0 is not None:
            m0 = Flat.of(m0).ravel(m0)
        model_step = step_s
        if model_state is None:
            model_state = lambda m: get_state(flat.unravel(m))  # noqa: E731
    elif m0 is None:
        raise ValueError(
            "m0 is required when the filter runs on its own model_step "
            "(the belief space's dimension cannot be inferred)")
    if model_state is None:
        model_state = lambda m: m                               # noqa: E731
    if model_h is None:
        model_h = lambda m: h(model_state(m))                   # noqa: E731

    m0 = s0 if m0 is None else torch.as_tensor(m0, dtype=dtype, device=dev)
    ns = m0.shape[0]
    Q = _cov(Q, ns, dtype, dev)
    R = _cov(R, m_dim, dtype, dev)
    P0 = 1e-2 * torch.eye(ns, dtype=dtype, device=dev) if P0 is None else _cov(P0, ns, dtype, dev)
    Lr = torch.linalg.cholesky(R)
    if normals is not None:
        normals = torch.as_tensor(normals, dtype=dtype, device=dev)
        n0 = normals[0]
        draw = lambda s, e: (normals[1 + s:1 + e],)  # noqa: E731
    else:
        gen = stream(seed, LQG_TAG, dev)
        n0 = torch.randn((m_dim,), generator=gen, dtype=dtype, device=dev)
        draw = lambda s, e: (torch.randn((e - s, m_dim), generator=gen,  # noqa: E731
                                         dtype=dtype, device=dev),)

    def h_s(s):
        return h(get_state(flat.unravel(s)))

    y0 = h_s(s0) + Lr @ n0
    m, P, nis0, ll0 = _update(m0, P0, y0, model_h, R, residual)

    def body(carry, inp):
        s_true, m, P = carry
        _, n = inp
        u = policy(model_state(m))
        s_true = step_s(s_true, u)
        y = h_s(s_true) + Lr @ n
        m_pred, P_pred = _predict(m, P, u, model_step, Q)
        m, P, nis, ll = _update(m_pred, P_pred, y, model_h, R, residual)
        return (s_true, m, P), (get_state(flat.unravel(s_true)), model_state(m), u, y, nis,
                                ll, P)

    Xs, Ms, Us, Ys, niss, lls, Ps = scan(body, (s0, m, P), (_steps(steps, s0),), graph=graph,
                                         draw=draw)
    return LQGResult(X=torch.cat([x0[None], Xs]), X_est=torch.cat([model_state(m)[None], Ms]),
                     U=Us, Y=torch.cat([y0[None], Ys]), nis=torch.cat([nis0[None], niss]),
                     loglik=ll0 + torch.sum(lls), cov=Ps[-1])


# ---------------------------------------------------------------------------
# Adaptive Koopman-LQR (online streaming refit + gain re-solve)
# ---------------------------------------------------------------------------

class AdaptiveLQRResult(NamedTuple):
    """Closed-loop trace and the live model/controller state: pass
    ``stats`` and ``u_eq`` back into :func:`simulate_adaptive_koopman_lqr`
    to resume the loop."""

    X: torch.Tensor               # (steps+1, n) closed-loop states
    U: torch.Tensor               # (steps, r) applied controls (incl. dither)
    stats: koopman.KoopmanStats   # final accumulator
    K: torch.Tensor               # (r, d) final lifted gains
    u_eq: torch.Tensor            # (r,) final hover command
    gain_deltas: torch.Tensor     # (n_segments,) ||K_j - K_{j-1}||_F / ||K_{j-1}||_F
    u_eqs: torch.Tensor           # (n_segments, r) command after each re-solve


_STATS_LIVE = ("gram", "rhs", "weight_sum", "prev_z", "prev_u", "prev_valid")


def simulate_adaptive_koopman_lqr(
    plant_step: Callable,
    carry0,
    stats0: koopman.KoopmanStats,
    x_ref,
    u_eq,
    steps: int,
    segment: int = 100,
    Q=None,
    R=None,
    ridge: Optional[float] = None,
    forgetting: float = 0.995,
    riccati_iters: int = 200,
    u_limit: float = 1.0,
    dither: float = 0.0,
    seed: int = 0,
    normals=None,
    retrim: bool = True,
    get_state: Callable = lambda c: c,
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> AdaptiveLQRResult:
    """Adaptive Koopman-LQR: every ``segment`` plant steps the closed-loop
    pairs enter the EDMDc statistics
    (``koopman.streaming_update_episode`` with RLS ``forgetting``), the
    lifted ``(A, B)`` re-solve (the float64 normal equations of
    ``koopman.streaming_finalize``, ``ridge`` relative to the mean Gram
    diagonal, default ``100 eps(dtype)``), the hover command re-trims on
    the state-readout rows (``min_u ||x_ref - C (A z_ref + B u)||``) unless
    ``retrim=False``, and the gains re-solve by ``riccati_iters`` Riccati
    iterations.  ``dither`` (std) adds ``dither * normals`` to every
    control before the clip: ``normals`` ``(steps, r)``, or draws of
    :func:`stream` ``(seed, ADAPTIVE_TAG)``, a segment at a time.  On the
    card a whole segment (its steps, the update and the re-solve) is one
    CUDA graph, replayed ``steps // segment`` times.
    """
    if segment < 1 or steps % segment != 0:
        raise ValueError(
            f"steps ({steps}) must be a positive multiple of segment "
            f"({segment})")
    n, d, r = stats0.state_dim, stats0.lift_dim, stats0.input_dim
    dtype, dev = stats0.gram.dtype, stats0.gram.device
    n_segments = steps // segment
    Q_lift, R = _lifted_costs(n, d, r, Q, R, dtype, dev)
    x_ref = torch.as_tensor(x_ref, dtype=dtype, device=dev)
    u_eq0 = torch.as_tensor(u_eq, dtype=dtype, device=dev)
    lam = torch.as_tensor(forgetting, dtype=dtype, device=dev)
    if ridge is None:
        ridge = 100.0 * float(torch.finfo(dtype).eps)
    z_ref = rbf_lift(x_ref, stats0.centers, stats0.gamma, stats0.rbf_weights)
    eye_r = torch.eye(r, dtype=dtype, device=dev)
    graph = use_graph(graph, dev)

    def solve(st, u_prev, riccati_graph):
        tr = torch.trace(st.gram) / st.gram.shape[0]
        model = koopman.streaming_finalize(st, ridge * tr)
        K, _ = _riccati_gain(model.A, model.B, Q_lift, R, riccati_iters, riccati_graph)
        if not retrim:
            return K, u_prev
        # re-trim on the state readout rows only: the RBF rows carry fit
        # noise that leaks through B's near-zero RBF rows into a large u
        with full_f32():
            resid = x_ref - (model.A @ z_ref)[:n]
            Bn = model.B[:n]
            BtB = Bn.T @ Bn
            M = BtB + (1e-5 * torch.trace(BtB) / r + 1e-12) * eye_r
            u_new = _cho_solve_vec(_chol(M), Bn.T @ resid)
        return K, torch.clamp(u_new, -u_limit, u_limit)

    with torch.no_grad():
        K0, u_init = solve(stats0, u_eq0, graph)
    carry = [t.clone() for t in _leaves(carry0)]
    live = [getattr(stats0, k).clone() for k in _STATS_LIVE]
    K, u_cur = K0.clone(), u_init.clone()
    nrm = torch.zeros((segment, r), dtype=dtype, device=dev)

    def run_segment():
        with torch.no_grad():
            c = _rebuild(carry0, carry)
            st = stats0._replace(**dict(zip(_STATS_LIVE, live)))
            x_first = get_state(c)
            xs, us = [], []
            for t in range(segment):
                z = rbf_lift(get_state(c), st.centers, st.gamma, st.rbf_weights)
                u = u_cur - (z - z_ref) @ K.T
                if dither > 0.0:
                    u = u + dither * nrm[t]
                u = torch.clamp(u, -u_limit, u_limit)
                c = plant_step(c, u)
                xs.append(get_state(c))
                us.append(u)
            Xs, Us = torch.stack(xs), torch.stack(us)
            st2 = koopman.streaming_update_episode(st, torch.cat([x_first[None], Xs]), Us, lam)
            K2, u2 = solve(st2, u_cur, False)
            delta = torch.linalg.norm(K2 - K) / torch.clamp(torch.linalg.norm(K), min=1e-30)
            for buf, v in zip(carry, _leaves(c)):
                buf.copy_(v)
            for buf, k in zip(live, _STATS_LIVE):
                buf.copy_(getattr(st2, k))
            K.copy_(K2)
            u_cur.copy_(u2)
            return Xs, Us, delta, u2

    (run,) = capture([run_segment], carry + live + [K, u_cur], graph, stats, ["segment"])
    if dither > 0.0:
        if normals is not None:
            normals = torch.as_tensor(normals, dtype=dtype, device=dev).reshape(
                n_segments, segment, r)
        else:
            gen = stream(seed, ADAPTIVE_TAG, dev)
    X = torch.empty((steps, n), dtype=dtype, device=dev)
    U = torch.empty((steps, r), dtype=dtype, device=dev)
    deltas = torch.empty(n_segments, dtype=dtype, device=dev)
    u_eqs = torch.empty((n_segments, r), dtype=dtype, device=dev)
    for j in range(n_segments):
        if dither > 0.0:
            if normals is not None:
                nrm.copy_(normals[j])
            else:
                nrm.normal_(generator=gen)
        Xs, Us, delta, u2 = run()
        rows = slice(j * segment, (j + 1) * segment)
        X[rows].copy_(Xs)
        U[rows].copy_(Us)
        deltas[j].copy_(delta)
        u_eqs[j].copy_(u2)
    stats_f = stats0._replace(**dict(zip(_STATS_LIVE, live)))
    return AdaptiveLQRResult(X=torch.cat([get_state(carry0)[None], X]), U=U, stats=stats_f,
                             K=K, u_eq=u_cur, gain_deltas=deltas, u_eqs=u_eqs)


# ---------------------------------------------------------------------------
# Receding-horizon MPC
# ---------------------------------------------------------------------------

def _planning_model(plant_step, get_state, model_step, model_carry, model_get_state):
    model = plant_step if model_step is None else model_step
    to_model = (lambda c: c) if model_carry is None else model_carry
    model_state = get_state if model_get_state is None else model_get_state
    return model, to_model, model_state


def simulate_mpc(
    plant_step: Callable,
    x0,
    x_target,
    sim_steps: int,
    horizon: int = 50,
    replan_iters: int = 10,
    init_iters: int = 200,
    lr: float = 0.1,
    u_limit: float = 1.0,
    effort_weight: float = 1e-3,
    state_weight=None,
    carry_init: Callable = lambda x: x,
    get_state: Callable = lambda c: c,
    u_dim: int = 8,
    model_step: Optional[Callable] = None,
    model_carry: Optional[Callable] = None,
    model_get_state: Optional[Callable] = None,
    dtype=torch.float32,
    device=None,
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
):
    """Closed-loop receding-horizon MPC; returns ``(X, U)``.

    A ``(horizon, u_dim)`` tanh-squashed plan is optimised by Adam on the
    stage-cost rollout ``mean_t w (x_t - x_target)^2 + effort *
    mean(tanh(V)^2)``: ``init_iters`` iterations from zeros, then at every
    plant step the first control is applied, the plan shifts one step (the
    last input repeated) and ``replan_iters`` iterations refine it, Adam's
    moments and count restarting at every replan as ``optax.adam``'s
    ``init`` does.  ``model_step``/``model_carry``/``model_get_state`` plan
    on another model than the plant executes (defaults: the plant's own).
    On the card an Adam iteration and the plant step (with the shift and
    the moments' reset) are each one CUDA graph, replayed on static
    buffers; ``stats`` receives the capture's seconds and, with
    ``stats["keep"]``, the replays ``"iteration"`` and ``"advance"``.
    """
    model, to_model, model_state = _planning_model(plant_step, get_state, model_step,
                                                   model_carry, model_get_state)
    dev = sysid._device_of(x0, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    x_target = torch.as_tensor(x_target, dtype=dtype, device=dev)
    w = (torch.ones_like(x_target) if state_weight is None
         else torch.as_tensor(state_weight, dtype=dtype, device=dev))
    like = carry_init(x0)
    carry = [t.clone() for t in _leaves(like)]
    V = torch.zeros((horizon, u_dim), dtype=dtype, device=dev, requires_grad=True)
    mu, nu = torch.zeros_like(V), torch.zeros_like(V)
    count = torch.zeros((), dtype=torch.float64, device=dev)

    def plan_cost():
        c = to_model(_rebuild(like, carry))
        costs = []
        for t in range(horizon):
            c = model(c, u_limit * torch.tanh(V[t]))
            costs.append(torch.sum(w * (model_state(c) - x_target) ** 2))
        return torch.mean(torch.stack(costs)) + effort_weight * torch.mean(torch.tanh(V) ** 2)

    def iteration():
        (g,) = torch.autograd.grad(plan_cost(), [V])
        sysid.adam_update([V], [g], [mu], [nu], count, lr)

    def advance():
        with torch.no_grad():
            u = u_limit * torch.tanh(V[0])
            for buf, v in zip(carry, _leaves(plant_step(_rebuild(like, carry), u))):
                buf.copy_(v)
            V.copy_(torch.cat([V[1:], V[-1:]]))
            for t in (mu, nu, count):
                t.zero_()
            return u

    X = torch.empty((sim_steps, x0.shape[-1]), dtype=dtype, device=dev)
    U = torch.empty((sim_steps, u_dim), dtype=dtype, device=dev)
    with full_f32():
        run_iter, run_advance = capture([iteration, advance], [V, mu, nu, count] + carry,
                                         use_graph(graph, dev), stats, ["iteration", "advance"])
        for _ in range(init_iters):
            run_iter()
        for k in range(sim_steps):
            U[k].copy_(run_advance())
            X[k].copy_(get_state(_rebuild(like, carry)))
            for _ in range(replan_iters):
                run_iter()
    return torch.cat([get_state(like)[None], X]), U


# ---------------------------------------------------------------------------
# Sampling-based MPC (MPPI)
# ---------------------------------------------------------------------------

def simulate_mppi(
    plant_step: Callable,
    x0,
    x_target,
    sim_steps: int,
    horizon: int = 60,
    n_samples: int = 512,
    sigma: float = 0.1,
    temperature: float = 0.01,
    init_rounds: int = 20,
    replan_rounds: int = 4,
    u_limit: float = 1.0,
    effort_weight: float = 1e-3,
    state_weight=None,
    extra_cost: Optional[Callable] = None,
    carry_init: Callable = lambda x: x,
    get_state: Callable = lambda c: c,
    u_dim: int = 8,
    model_step: Optional[Callable] = None,
    model_carry: Optional[Callable] = None,
    model_get_state: Optional[Callable] = None,
    seed: int = 0,
    normals=None,
    dtype=torch.float32,
    device=None,
    mesh=None,
    data_axis: str = "data",
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
):
    """Closed-loop MPPI (Model Predictive Path Integral control); returns
    ``(X, U)``.

    Every sampling round perturbs the plan by ``eps = sigma * normals``
    ``(n_samples, horizon, u_dim)``, rolls all ``clip(U + eps)`` through the
    planning model as one batch, weights the noise by ``softmax(-(S -
    min S) / temperature)`` of the mean stage costs ``S`` (the weights cast
    to the plan's dtype) and moves the plan by the weighted noise.
    ``init_rounds`` rounds refine the initial zero plan; at every plant
    step the first control is applied, the plan shifts and
    ``replan_rounds`` rounds follow.  ``extra_cost(x, u)`` adds a
    per-sample cost (which needs no gradient: an obstacle indicator).

    The draws: ``normals`` ``(init_rounds + sim_steps * replan_rounds,
    n_samples, horizon, u_dim)``, or a round at a time from :func:`stream`
    ``(seed, MPPI_TAG)`` on the device.  ``mesh`` splits the sample axis
    over the ranks of its ``data_axis`` (contiguous blocks); every rank
    draws the whole round and keeps its block, so the draws equal the
    unsharded call's, and the minimum of ``S``, the softmax's denominator
    and the weighted noise sum are all-reduced; that path runs eagerly.
    Without a mesh, on the card a round and the plant step are each one
    CUDA graph replayed on static buffers; ``stats`` receives the
    capture's seconds and, with ``stats["keep"]``, the replays ``"round"``
    and ``"advance"``.
    """
    model, to_model, model_state = _planning_model(plant_step, get_state, model_step,
                                                   model_carry, model_get_state)
    dev = sysid._device_of(x0, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    x_target = torch.as_tensor(x_target, dtype=dtype, device=dev)
    w = (torch.ones_like(x_target) if state_weight is None
         else torch.as_tensor(state_weight, dtype=dtype, device=dev))
    lo, hi, reduce = 0, n_samples, None
    if mesh is not None:
        if graph:
            raise ValueError("simulate_mppi with a mesh runs eagerly; pass graph=None or False")
        import torch.distributed as dist

        from bluerov2_dynamics_tpu_torch.parallel.mesh import axis
        from bluerov2_dynamics_tpu_torch.parallel.sharded import _block

        group, size, index = axis(mesh, data_axis)
        lo, hi = _block(n_samples, size, index)

        def reduce(t, op):
            dist.all_reduce(t, op=op, group=group)
            return t

        graph = False
    like = carry_init(x0)
    carry = [t.clone() for t in _leaves(like)]
    U = torch.zeros((horizon, u_dim), dtype=dtype, device=dev)
    eps = torch.zeros((n_samples, horizon, u_dim), dtype=dtype, device=dev)
    n_rounds = init_rounds + sim_steps * replan_rounds
    if normals is not None:
        normals = torch.as_tensor(normals, dtype=dtype, device=dev)
        if normals.shape != (n_rounds, n_samples, horizon, u_dim):
            raise ValueError(f"normals must have shape {(n_rounds, n_samples, horizon, u_dim)}, "
                             f"got {tuple(normals.shape)}")
    else:
        gen = stream(seed, MPPI_TAG, dev)

    def draw(i):
        if normals is not None:
            eps.copy_(sigma * normals[i])
        else:
            eps.normal_(generator=gen).mul_(sigma)

    def stage_cost(x, u):
        c = torch.sum(w * (x - x_target) ** 2, dim=-1) + effort_weight * torch.sum(u ** 2, dim=-1)
        return c if extra_cost is None else c + extra_cost(x, u)

    def round_():
        with torch.no_grad():
            e = eps[lo:hi]
            k = hi - lo
            cand = torch.clamp(U[None] + e, -u_limit, u_limit)
            mc = to_model(_rebuild(like, carry))
            c = _rebuild(mc, [t.expand(k, *t.shape).contiguous() for t in _leaves(mc)])
            costs = []
            for t in range(horizon):
                u = cand[:, t]
                c = model(c, u)
                costs.append(stage_cost(model_state(c), u))
            S = torch.mean(torch.stack(costs), dim=0)
            s_min = torch.min(S)
            if reduce is not None:
                s_min = reduce(s_min.clone(), dist.ReduceOp.MIN)
            ex = torch.exp(-(S - s_min) / temperature)
            den = torch.sum(ex)
            if reduce is not None:
                den = reduce(den, dist.ReduceOp.SUM)
            wts = (ex / den).to(dtype)
            with full_f32():
                dU = torch.tensordot(wts, e, dims=1)
            if reduce is not None:
                dU = reduce(dU, dist.ReduceOp.SUM)
            U.copy_(torch.clamp(U + dU, -u_limit, u_limit))
            return S

    def advance():
        with torch.no_grad():
            u = U[0].clone()
            for buf, v in zip(carry, _leaves(plant_step(_rebuild(like, carry), u))):
                buf.copy_(v)
            U.copy_(torch.cat([U[1:], U[-1:]]))
            return u

    run_round, run_advance = capture([round_, advance], [U] + carry, use_graph(graph, dev),
                                      stats, ["round", "advance"])
    X = torch.empty((sim_steps, x0.shape[-1]), dtype=dtype, device=dev)
    U_applied = torch.empty((sim_steps, u_dim), dtype=dtype, device=dev)
    i = 0
    for _ in range(init_rounds):
        draw(i)
        run_round()
        i += 1
    for k in range(sim_steps):
        U_applied[k].copy_(run_advance())
        X[k].copy_(get_state(_rebuild(like, carry)))
        for _ in range(replan_rounds):
            draw(i)
            run_round()
            i += 1
    return torch.cat([get_state(like)[None], X]), U_applied


# ---------------------------------------------------------------------------
# iLQR + time-varying LQR tracking
# ---------------------------------------------------------------------------

class ILQRResult(NamedTuple):
    """Output of :func:`ilqr`: the tracking policy ``v_t = V[t] + K[t] (s -
    S[t])``, ``u = u_limit tanh(v)`` (``u = v`` unsquashed), on the
    flattened carry ``s``."""

    U: torch.Tensor       # (H, r) optimal (squashed) control sequence
    X: torch.Tensor       # (H+1, n) get_state trajectory under U
    V: torch.Tensor       # (H, r) raw decision variables (pre-squash)
    K: torch.Tensor       # (H, r, ns) time-varying feedback gains
    S: torch.Tensor       # (H+1, ns) flattened reference carry trajectory
    costs: torch.Tensor   # (iters+1,) total cost before the first sweep, then after each


def ilqr(
    step: Callable,
    x0,
    x_target,
    horizon: int,
    iters: int = 20,
    u_limit: Optional[float] = 1.0,
    effort_weight: float = 1e-3,
    state_weight=None,
    terminal_weight=None,
    mu0: float = 1.0,
    n_alphas: int = 8,
    carry_init: Callable = lambda x: x,
    get_state: Callable = lambda c: c,
    u_dim: int = 8,
    dtype=torch.float32,
    device=None,
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> ILQRResult:
    """Iterative LQR: each sweep linearises the step along the current
    trajectory (every row's Jacobians in one batched reverse-mode call,
    ``estimation._jac``; the cost's gradients and Hessians by
    ``torch.func``), runs the Riccati backward pass with Levenberg ``mu``
    on ``Q_uu`` (Cholesky solves that give NaN on an indefinite ``Q_uu``),
    and rolls all step sizes ``1, 1/2, ..., 2^-(n_alphas-1)`` and ``0`` out
    as one batch.  NaN costs are masked to ``+inf`` before the argmin (the
    first minimum wins); a sweep that does not lower the cost by ``1e-12``
    keeps the previous iterate explicitly (NaN gains would poison every
    candidate, ``alpha = 0`` included); ``mu`` halves on an accepted sweep
    and grows 10x on a rejected one (clipped to ``[1e-8, 1e10]``), and the
    final gains are recomputed at the last accepted ``mu``.  Costs:
    ``sum_t [w (x_t - x*)^2 + effort u_t^2] + w_f (x_H - x*)^2``, ``w_f``
    defaulting to ``100 w``; ``u_limit=None`` disables the squash.  Every
    GEMM in full float32 (no TF32).  On the card a sweep is one CUDA graph,
    replayed ``iters`` times; ``stats`` receives the capture's seconds and,
    with ``stats["keep"]``, the replay ``"sweep"``.
    """
    dev = sysid._device_of(x0, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    x_target = torch.as_tensor(x_target, dtype=dtype, device=dev)
    w = (torch.ones_like(x_target) if state_weight is None
         else torch.as_tensor(state_weight, dtype=dtype, device=dev))
    wf = (100.0 * w if terminal_weight is None
          else torch.as_tensor(terminal_weight, dtype=dtype, device=dev))
    carry0 = carry_init(x0)
    flat = Flat.of(carry0)
    s0 = flat.ravel(carry0).to(dtype)
    ns = s0.shape[0]

    def squash(v):
        return v if u_limit is None else u_limit * torch.tanh(v)

    def fv(s, v):
        return flat.ravel(step(flat.unravel(s), squash(v))).to(dtype)

    def gx(s):
        return get_state(flat.unravel(s))

    def stage_cost(s, v):
        dx = gx(s) - x_target
        return torch.sum(w * dx ** 2, dim=-1) + effort_weight * torch.sum(squash(v) ** 2, dim=-1)

    def term_cost(s):
        return torch.sum(wf * (gx(s) - x_target) ** 2, dim=-1)

    def l_sv(sv):
        return stage_cost(sv[:ns], sv[ns:])

    eye_r = torch.eye(u_dim, dtype=dtype, device=dev)
    alphas = torch.cat([0.5 ** torch.arange(n_alphas, dtype=dtype, device=dev),
                        torch.zeros(1, dtype=dtype, device=dev)])

    def backward(S, V, mu):
        SV = torch.cat([S[:-1], V], dim=-1)
        J, _ = _jac(lambda sv: fv(sv[:ns], sv[ns:]), SV, ns)      # (H, ns, ns + r)
        A, B = J[..., :ns], J[..., ns:]
        g = vmap(grad(l_sv))(SV)
        Hs = vmap(hessian(l_sv))(SV)
        lx, lu = g[:, :ns], g[:, ns:]
        lxx, luu, lux = Hs[:, :ns, :ns], Hs[:, ns:, ns:], Hs[:, ns:, :ns]
        Vx = grad(term_cost)(S[-1])
        Vxx = hessian(term_cost)(S[-1])
        k_ff, K_fb = [None] * horizon, [None] * horizon
        for t in reversed(range(horizon)):
            At, Bt = A[t], B[t]
            Qx = lx[t] + At.T @ Vx
            Qu = lu[t] + Bt.T @ Vx
            Qxx = lxx[t] + At.T @ Vxx @ At
            Quu = luu[t] + Bt.T @ Vxx @ Bt + mu * eye_r
            Qux = lux[t] + Bt.T @ Vxx @ At
            L = _chol(Quu)
            kt = -_cho_solve_vec(L, Qu)
            Kt = -_cho_solve(L, Qux)
            Vx = Qx + Kt.T @ Quu @ kt + Kt.T @ Qu + Qux.T @ kt
            Vxx = Qxx + Kt.T @ Quu @ Kt + Kt.T @ Qux + Qux.T @ Kt
            Vxx = (Vxx + Vxx.T) / 2.0
            k_ff[t], K_fb[t] = kt, Kt
        return torch.stack(k_ff), torch.stack(K_fb)

    def forward(V_ref, S_ref, k_ff, K_fb):
        s = S_ref[0].expand(alphas.shape[0], ns)
        Vs, Ss, cs = [], [], []
        for t in range(horizon):
            v = V_ref[t] + alphas[:, None] * k_ff[t] + ((s - S_ref[t]) @ K_fb[t].T)
            Vs.append(v)
            Ss.append(s)
            cs.append(stage_cost(s, v))
            s = fv(s, v)
        Ss.append(s)
        cost = torch.sum(torch.stack(cs), dim=0) + term_cost(s)
        return cost, torch.stack(Vs, dim=1), torch.stack(Ss, dim=1)

    V = torch.zeros((horizon, u_dim), dtype=dtype, device=dev)
    with full_f32():
        def roll(c, inp):
            (s,), (v,) = c, inp
            s1 = fv(s, v)
            return (s1,), (s, stage_cost(s, v), s1)

        S_rows, cs, s1 = scan(roll, (s0,), (V,), graph=graph)
        S = torch.cat([S_rows, s1[-1:]])
        cost = torch.sum(cs) + term_cost(s1[-1])
        cost0 = cost.clone()
        mu = torch.full((), mu0, dtype=dtype, device=dev)
        mu_good = mu.clone()

        def sweep():
            with torch.no_grad():
                k_ff, K_fb = backward(S, V, mu)
                costs_a, V_a, S_a = forward(V, S, k_ff, K_fb)
                costs_a = torch.where(torch.isnan(costs_a), torch.inf, costs_a)
                best = torch.argmin(costs_a).reshape(1)
                c_best = costs_a.index_select(0, best)[0]
                improved = c_best < cost - 1e-12
                mu_good.copy_(torch.where(improved, mu, mu_good))
                mu.copy_(torch.clamp(torch.where(improved, mu * 0.5, mu * 10.0), 1e-8, 1e10))
                V.copy_(torch.where(improved, V_a.index_select(0, best)[0], V))
                S.copy_(torch.where(improved, S_a.index_select(0, best)[0], S))
                cost.copy_(torch.where(improved, c_best, cost))
                return cost

        (run,) = capture([sweep], [V, S, cost, mu, mu_good], use_graph(graph, dev), stats,
                          ["sweep"])
        costs = torch.empty(iters + 1, dtype=dtype, device=dev)
        costs[0] = cost0
        for i in range(iters):
            costs[i + 1].copy_(run())
        with torch.no_grad():
            _, K_fb = backward(S, V, mu_good)
    return ILQRResult(U=squash(V), X=gx(S), V=V, K=K_fb, S=S, costs=costs)


def simulate_tvlqr(plant_step: Callable, res: ILQRResult, carry0,
                   u_limit: Optional[float] = 1.0, get_state: Callable = lambda c: c,
                   graph: Optional[bool] = None):
    """Execute an :func:`ilqr` plan closed-loop with its own gains: ``v_t =
    V[t] + K[t] (s_t - S[t])`` on the flattened plant carry, squashed like
    the planner (``u_limit`` must match the :func:`ilqr` call).  Returns
    ``(X, U)`` like :func:`simulate_closed_loop`."""
    flat = Flat.of(carry0)

    def body(c, inp):
        v_ref, s_ref, Kt = inp
        carry = _rebuild(carry0, c)
        s = flat.ravel(carry).to(s_ref.dtype)
        v = v_ref + Kt @ (s - s_ref)
        u = v if u_limit is None else u_limit * torch.tanh(v)
        carry = plant_step(carry, u)
        return tuple(_leaves(carry)), (get_state(carry), u)

    X, U = scan(body, _leaves(carry0), (res.V, res.S[:-1], res.K), graph=graph)
    return torch.cat([get_state(carry0)[None], X]), U


# ---------------------------------------------------------------------------
# Direct trajectory optimization
# ---------------------------------------------------------------------------

class TrajoptResult(NamedTuple):
    U: torch.Tensor        # (H, r) optimized (squashed) control sequence
    X: torch.Tensor        # (H+1, n) resulting state trajectory
    losses: torch.Tensor   # (steps,) optimization loss history


def trajopt(
    step: Callable,
    x0,
    x_target,
    horizon: int,
    steps: int = 300,
    lr: float = 0.05,
    u_limit: float = 1.0,
    effort_weight: float = 1e-3,
    terminal_weight=None,
    carry_init: Callable = lambda x: x,
    get_state: Callable = lambda c: c,
    u_dim: int = 8,
    dtype=torch.float32,
    device=None,
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
) -> TrajoptResult:
    """Open-loop control sequence reaching ``x_target`` from ``x0``: Adam
    over ``V`` with ``u = u_limit tanh(V)``, loss = weighted terminal error
    + ``effort_weight * mean(u^2)``, differentiated through the rollout.
    On the card one Adam iteration (rollout, backward pass, update) is a
    CUDA graph replayed ``steps`` times (``sysid._run_adam``; ``stats`` as
    there)."""
    dev = sysid._device_of(x0, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    x_target = torch.as_tensor(x_target, dtype=dtype, device=dev)
    w = (torch.ones_like(x_target) if terminal_weight is None
         else torch.as_tensor(terminal_weight, dtype=dtype, device=dev))
    carry0 = carry_init(x0)

    def loss_fn(theta):
        U = u_limit * torch.tanh(theta["V"])
        carry = carry0
        for t in range(horizon):
            carry = step(carry, U[t])
        return (torch.sum(w * (get_state(carry) - x_target) ** 2)
                + effort_weight * torch.mean(U ** 2))

    theta, losses = sysid._run_adam(
        loss_fn, {"V": torch.zeros((horizon, u_dim), dtype=dtype, device=dev)}, steps, lr,
        graph=use_graph(graph, dev), warmup=1, stats=stats)
    U = u_limit * torch.tanh(theta["V"])

    def body(c, inp):
        carry = step(_rebuild(carry0, c), inp[0])
        return tuple(_leaves(carry)), (get_state(carry),)

    (X,) = scan(body, _leaves(carry0), (U,), graph=graph)
    return TrajoptResult(U=U, X=torch.cat([x0[None], X]), losses=losses)

"""State estimation on the framework's dynamics models (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/estimation.py``:

* :func:`kalman_filter` — the linear time-invariant Kalman filter;
* :func:`ekf` — the extended Kalman filter over any discrete step function,
  with exact Jacobians at every step (:func:`_jac`);
* :func:`ukf` — the unscented Kalman filter (sigma points through the full
  nonlinear step, no Jacobians);
* :func:`rts_smooth` / :func:`ekf_smooth` — the Rauch-Tung-Striebel
  backward pass (a reversed scan);
* :func:`koopman_kalman_filter` — the exact linear filter on the lifted
  system of a fitted EDMDc model;
* :func:`particle_filter` — the bootstrap particle filter, the particles a
  batch axis through the full step, with systematic resampling;
* :func:`mhe` — moving-horizon estimation, Adam on whitened decision
  variables in each window, with an optional Huber penalty;
* :func:`fit_noise` — maximum-likelihood diagonal Q/R by Adam on the
  filter's innovation log-likelihood;
* :func:`manifold_ekf` / :func:`manifold_rts_smooth` /
  :func:`mekf_quat13` — the error-state filter and smoother on a manifold
  given by its box operators, and the quat13 multiplicative EKF;
* :func:`nees`, :func:`segment_trajectory`.

Conventions (shared by every filter, as in the JAX package): ``Y`` is
``(T, m)``, ``U`` is ``(T-1, r)`` with ``U[k]`` driving the transition
``k -> k+1``; the prior ``(m0, P0)`` is updated with ``Y[0]`` first.
Updates use the Joseph form and a Cholesky solve of the innovation
covariance; each filter returns the Gaussian innovation log-likelihood and
the per-step NIS.  ``step(x, u)`` and ``h(x)`` act on one state; banks
and ensembles apply them through ``torch.func.vmap``.

**Step loops.**  Every filter and smoother is a :func:`~bluerov2_dynamics_tpu_torch.ops.scan.scan`:
the eager loop on the CPU (the plain version), replays of a captured CUDA
graph of ``ops.scan.GRAPH_CHUNK`` steps on the card (``graph=None`` picks by
device).  So
nothing in a step may read a value back to the host: the Cholesky
factorisations are ``torch.linalg.cholesky_ex`` with the failure turned
into NaN on the device (JAX's ``cho_factor`` returns NaN there), the
solves two triangular solves, the particle filter's resampling branch is
computed and selected by ``torch.where`` (JAX's ``lax.cond``), and the
random draws are made outside the graph, chunk by chunk.
:func:`fit_noise` captures a whole Adam iteration (the filter bank and its
backward pass) through ``sysid._run_adam``, and :func:`mhe` an iteration
of a window's Adam loop, replayed ``iters`` times a window.

**Random streams.**  The particle filter draws from a ``torch.Generator``
on the data's device seeded from ``(seed, tag)`` (``(seed, tag, i)`` for
the ``i``-th filter of a bank), not from threefry;
:func:`particle_filter_from_draws` takes the draws as arguments, which is
how the tests feed it the JAX package's own.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from bluerov2_dynamics_tpu_torch.models import sysid
from bluerov2_dynamics_tpu_torch.models.koopman import KoopmanModel, lift
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.ops.quaternion import quat_exp, quat_log, quat_multiply
from bluerov2_dynamics_tpu_torch.ops.scan import _side_stream, capture, scan, use_graph

_LOG2PI = 1.8378770664093453
PF_TAG = 7          # stream tag of the particle filter's draws


class FilterResult(NamedTuple):
    """Output of a forward filtering pass."""

    means: torch.Tensor   # (T, n) posterior means
    covs: torch.Tensor    # (T, n, n) posterior covariances
    loglik: torch.Tensor  # scalar: sum_k log N(y_k | innovation)
    nis: torch.Tensor     # (T,) normalized innovation squared (chi^2_m)


class SmootherResult(NamedTuple):
    """Output of a forward-backward (RTS) smoothing pass."""

    means: torch.Tensor   # (T, n) smoothed means
    covs: torch.Tensor    # (T, n, n) smoothed covariances
    filtered: FilterResult


class ParticleFilterResult(NamedTuple):
    """Output of a particle-filtering pass (weighted-ensemble posterior)."""

    means: torch.Tensor   # (T, n) weighted posterior means
    covs: torch.Tensor    # (T, n, n) weighted posterior covariances
    loglik: torch.Tensor  # scalar: sum_k log p_hat(y_k | y_{:k}) evidence
    ess: torch.Tensor     # (T,) effective sample size after each update


class MHEResult(NamedTuple):
    """Output of a receding-horizon MHE pass."""

    means: torch.Tensor   # (T, n) first window smoothed, then each window's end
    losses: torch.Tensor  # (T - window + 1,) final cost per window


class NoiseFitResult(NamedTuple):
    """Result of :func:`fit_noise` (maximum-likelihood Q/R)."""

    Q: torch.Tensor       # (n, n) fitted (diagonal) process covariance
    R: torch.Tensor       # (m, m) fitted (diagonal) measurement covariance
    log_q: torch.Tensor   # (n,) fitted log-diagonal of Q
    log_r: torch.Tensor   # (m,) fitted log-diagonal of R
    losses: torch.Tensor  # (steps,) negative mean loglik history


# ---------------------------------------------------------------------------
# Shared cores
# ---------------------------------------------------------------------------

def _sym(P):
    return (P + P.transpose(-1, -2)) * 0.5


def _chol(A):
    """Lower Cholesky factor, NaN where the factorisation fails (no host
    read of the status, so that a CUDA graph can capture it)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _cho_solve(L, B):
    """``A^-1 B`` from the lower factor ``L`` of ``A``, ``B`` ``(..., n, k)``."""
    Z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Z, upper=True)


def _cho_solve_vec(L, b):
    return _cho_solve(L, b[..., None])[..., 0]


def _logdet(L):
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def _mv(A, v):
    """Matrix-vector product over leading batch dimensions."""
    return (A @ v[..., None])[..., 0]


def _jac(f, x, k: int, *args):
    """``(J, f(x, *args))``: the exact Jacobian ``J = df/dx`` ``(..., k,
    n)`` of ``f: R^n -> R^k`` at ``x`` ``(..., n)`` and the value, by
    reverse mode on ``k`` copies of ``x``: ``vmap(f)`` on them, then one
    backward pass with the identity as the cotangents (row ``i`` of the
    result is ``J^T e_i``).  ``f`` acts on one state; leading dimensions
    of ``x`` (and of ``args``, which are not differentiated) are a bank,
    through ``vmap``.  The JAX package uses ``jax.jacfwd``; PyTorch's
    forward mode costs about four times the host time an operation (and a
    step's host time is what the eager loop and a CUDA graph's capture
    pay), for as many kernels.  Where ``x`` carries a gradient (the filter
    inside :func:`fit_noise`) the backward pass is recorded, so that ``J``
    and ``f(x)`` carry it on."""
    create = x.requires_grad and torch.is_grad_enabled()
    batch = x.shape[:-1]
    fb = vmap(f, in_dims=(0,) + (None,) * len(args))
    for _ in batch:
        fb = vmap(fb)
    with torch.enable_grad():
        X = (x if create else x.detach()).unsqueeze(-2).repeat(*([1] * len(batch)), k, 1)
        if not create:
            X.requires_grad_(True)
        out = fb(X, *args)
        eye = torch.eye(k, dtype=out.dtype, device=out.device).expand(*batch, k, k)
        (J,) = torch.autograd.grad(out, X, eye, create_graph=create)
    value = out[..., 0, :]
    return (J, value) if create else (J.detach(), value.detach())


def _tangent_update(v, H, P, R):
    """Joseph-form Kalman measurement update in (tangent) coordinates:
    innovation ``v``, linearized measurement ``H`` -> correction ``delta``
    plus updated covariance / NIS / loglik.  The shared core of
    :func:`ekf` and :func:`manifold_ekf`; leading dimensions are a bank."""
    S = H @ P @ H.mT + R
    L = _chol(_sym(S))
    K = _cho_solve(L, H @ P).mT                 # P H^T S^{-1}
    delta = _mv(K, v)
    ImKH = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K @ H
    P_new = _sym(ImKH @ P @ ImKH.mT + K @ R @ K.mT)
    nis = torch.sum(v * _cho_solve_vec(L, v), dim=-1)
    ll = -0.5 * (nis + _logdet(L) + v.shape[-1] * _LOG2PI)
    return delta, P_new, nis, ll


def _rts_backstep(F, P_f, Q, P_next_s):
    """Shared RTS gain and covariance recursion: ``(G, P_pred, P_s)``."""
    P_pred = _sym(F @ P_f @ F.mT + Q)
    L = _chol(P_pred)
    G = _cho_solve(L, F @ P_f).mT               # P_f F^T P_pred^{-1}
    P_s = _sym(P_f + G @ (P_next_s - P_pred) @ G.mT)
    return G, P_pred, P_s


def _update(m, P, y, h: Callable, R, residual: Optional[Callable]):
    """Joseph-form measurement update; returns ``(m+, P+, nis, loglik)``.
    Leading dimensions of ``m``, ``P``, ``y`` are a bank."""
    H, hm = _jac(h, m, y.shape[-1])
    if residual is None:
        v = y - hm
    else:
        v = residual(y, hm) if y.ndim == 1 else vmap(residual)(y, hm)
    delta, P_new, nis, ll = _tangent_update(v, H, P, R)
    return m + delta, P_new, nis, ll


def _predict(m, P, u, step: Callable, Q):
    """EKF time update: the exact linearisation (:func:`_jac`) at the
    posterior.  The shared core of :func:`ekf` and of the in-loop filter
    of the LQG simulation."""
    F, m_pred = _jac(step, m, m.shape[-1], u)
    P_pred = _sym(F @ P @ F.mT + Q)
    return m_pred, P_pred


def _check_inputs(U, Y, axis: int = 0):
    if Y.shape[axis] != U.shape[axis] + 1:
        if axis == 0:
            raise ValueError(
                f"U must have T-1={Y.shape[0] - 1} rows (transition inputs), "
                f"got {U.shape[0]}")
        raise ValueError(
            f"U must have T-1={Y.shape[1] - 1} transition inputs per "
            f"trajectory, got {U.shape[1]}")


def _tensors(ref, *xs):
    """Each of ``xs`` as a tensor on ``ref``'s device (dtypes kept)."""
    ref = torch.as_tensor(ref)
    return tuple(None if x is None else torch.as_tensor(x, device=ref.device) for x in xs)


def _time_major(x):
    return x.transpose(0, 1)


def _run_filter(first: Callable, body: Callable, m0, P0, U, Y, graph, batched: bool):
    """The shared loop of the forward filters: ``first(m0, P0, y0) ->
    (m, P, nis, ll)`` on ``Y[0]``, then the scan of ``body((m, P), (u, y))
    -> ((m, P), (m, P, nis, ll))`` over the remaining rows.  ``batched``:
    ``m0``, ``U``, ``Y`` carry a leading bank axis, which ``first`` and
    ``body`` take as leading dimensions."""
    if batched:
        P0 = P0.expand(m0.shape[0], *P0.shape)
        U, Y = _time_major(U), _time_major(Y)
    m, P, nis0, ll0 = first(m0, P0, Y[0])
    ms, Ps, niss, lls = scan(body, (m, P), (U, Y[1:]), graph=graph)
    res = FilterResult(means=torch.cat([m[None], ms]), covs=torch.cat([P[None], Ps]),
                       loglik=ll0 + torch.sum(lls, dim=0),
                       nis=torch.cat([nis0[None], niss]))
    if batched:
        res = res._replace(means=_time_major(res.means), covs=_time_major(res.covs),
                           nis=_time_major(res.nis))
    return res


# ---------------------------------------------------------------------------
# EKF, UKF, RTS
# ---------------------------------------------------------------------------

def ekf(step: Callable, h: Callable, Q, R, m0, P0, U, Y,
        residual: Optional[Callable] = None, graph: Optional[bool] = None,
        batched: bool = False) -> FilterResult:
    """Extended Kalman filter over an arbitrary discrete step function.

    ``step(x, u) -> x'`` (e.g. ``fossen.make_wrench_step``) and ``h(x) ->
    y`` are linearised exactly at every step (:func:`_jac`).
    ``residual(y, y_pred)`` optionally replaces the innovation ``y - h(m)``
    (e.g. ``ops.rotations.ssa`` on wrapped angle channels).  ``batched``:
    a bank of independent filters, ``m0`` ``(B, n)``, ``U`` ``(B, T-1,
    r)``, ``Y`` ``(B, T, m)`` (``Q``, ``R``, ``P0`` shared) — JAX's
    ``vmap(ekf)``.  ``graph`` as in :func:`~bluerov2_dynamics_tpu_torch.ops.scan.use_graph`.
    """
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U = _tensors(Y, Q, R, m0, P0, U)
    _check_inputs(U, Y, 1 if batched else 0)

    def first(m, P, y):
        return _update(m, P, y, h, R, residual)

    def body(carry, inp):
        m, P = carry
        u, y = inp
        m_pred, P_pred = _predict(m, P, u, step, Q)
        m, P, nis, ll = _update(m_pred, P_pred, y, h, R, residual)
        return (m, P), (m, P, nis, ll)

    return _run_filter(first, body, m0, P0, U, Y, graph, batched)


def _sigma_weights(n: int, alpha: float, beta: float, kappa: float, dtype, device):
    """Merwe scaling ``lam`` and the mean / covariance weights."""
    lam = alpha * alpha * (n + kappa) - n
    wm = torch.full((2 * n + 1,), 0.5 / (n + lam), dtype=dtype, device=device)
    wm[0] = lam / (n + lam)
    wc = wm.clone()
    wc[0] += 1.0 - alpha * alpha + beta
    return lam, wm, wc


def _sigma_points(m, P, n: int, lam: float):
    """Merwe scaled sigma points ``(2n+1, n)`` of an ``(n,)`` mean /
    ``(n, n)`` covariance."""
    L = _chol(_sym(P) * (n + lam))
    return torch.cat([m[None], m[None] + L.T, m[None] - L.T])


def ukf(step: Callable, h: Callable, Q, R, m0, P0, U, Y, alpha: float = 1.0,
        beta: float = 2.0, kappa: float = 0.0, residual: Optional[Callable] = None,
        graph: Optional[bool] = None) -> FilterResult:
    """Unscented Kalman filter: sigma points through the full nonlinear
    step and measurement, no Jacobians.  Same contract as :func:`ekf`;
    Merwe scaling defaults (alpha=1, beta=2, kappa=0) as in the JAX
    package."""
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U = _tensors(Y, Q, R, m0, P0, U)
    _check_inputs(U, Y)
    n = m0.shape[0]
    lam, wm, wc = _sigma_weights(n, alpha, beta, kappa, m0.dtype, m0.device)
    h_batch = vmap(h)

    def ut_update(m, P, y):
        pts = _sigma_points(m, P, n, lam)
        ys = h_batch(pts)                          # (2n+1, m)
        y_mean = wm @ ys
        dy = ys - y_mean
        dx = pts - m
        S = _sym((dy * wc[:, None]).T @ dy + R)
        C = (dx * wc[:, None]).T @ dy              # cross-covariance (n, m)
        L = _chol(S)
        K = _cho_solve(L, C.T).T                   # C S^{-1}
        v = y - y_mean if residual is None else residual(y, y_mean)
        m_new = m + K @ v
        P_new = _sym(P - K @ S @ K.T)
        nis = v @ _cho_solve_vec(L, v)
        ll = -0.5 * (nis + _logdet(L) + y.shape[0] * _LOG2PI)
        return m_new, P_new, nis, ll

    def body(carry, inp):
        m, P = carry
        u, y = inp
        pts = _sigma_points(m, P, n, lam)
        xs = vmap(lambda xx: step(xx, u))(pts)
        m_pred = wm @ xs
        dx = xs - m_pred
        P_pred = _sym((dx * wc[:, None]).T @ dx + Q)
        m, P, nis, ll = ut_update(m_pred, P_pred, y)
        return (m, P), (m, P, nis, ll)

    return _run_filter(ut_update, body, m0, P0, U, Y, graph, False)


def _smoother_result(ms, Ps, filtered) -> SmootherResult:
    return SmootherResult(means=torch.cat([ms, filtered.means[-1:]]),
                          covs=torch.cat([Ps, filtered.covs[-1:]]), filtered=filtered)


def rts_smooth(step: Callable, Q, U, filtered: FilterResult,
               graph: Optional[bool] = None) -> SmootherResult:
    """Rauch-Tung-Striebel backward pass on a filtered trajectory,
    re-linearising ``step`` at the filtered means.  Those are known before
    the pass starts, so every step's Jacobian and prediction come from one
    batched :func:`_jac` call; the reversed scan is the gain and
    covariance recursion alone."""
    means_f, covs_f = filtered.means, filtered.covs
    Q, U = _tensors(means_f, Q, U)
    F, m_pred = _jac(step, means_f[:-1], means_f.shape[-1], U)

    def body(carry, inp):
        m_next_s, P_next_s = carry
        m_f, P_f, F, m_pred = inp
        G, P_pred, P_s = _rts_backstep(F, P_f, Q, P_next_s)
        m_s = m_f + _mv(G, m_next_s - m_pred)
        return (m_s, P_s), (m_s, P_s)

    ms, Ps = scan(body, (means_f[-1], covs_f[-1]), (means_f[:-1], covs_f[:-1], F, m_pred),
                  graph=graph, reverse=True)
    return _smoother_result(ms, Ps, filtered)


def ekf_smooth(step, h, Q, R, m0, P0, U, Y, residual: Optional[Callable] = None,
               graph: Optional[bool] = None) -> SmootherResult:
    """Forward EKF + RTS backward pass in one call."""
    return rts_smooth(step, Q, U, ekf(step, h, Q, R, m0, P0, U, Y, residual, graph), graph)


def kalman_filter(A, B, H, Q, R, m0, P0, U, Y, graph: Optional[bool] = None) -> FilterResult:
    """Linear time-invariant Kalman filter ``x+ = A x + B u, y = H x``:
    :func:`ekf` on the linear step."""
    A, B, H = _tensors(Y, A, B, H)
    return ekf(lambda x, u: A @ x + B @ u, lambda x: H @ x, Q, R, m0, P0, U, Y,
               graph=graph)


# ---------------------------------------------------------------------------
# Lifted (Koopman) Kalman filter
# ---------------------------------------------------------------------------

def koopman_readout(model: KoopmanModel):
    """The lifted system's measurement matrix ``(n, d)``: the decoder, or
    ``[I 0]`` (the first ``n`` lifted coordinates)."""
    if model.decoder is not None:
        return model.decoder
    n, d = model.state_dim, model.lift_dim
    return torch.eye(n, d, dtype=model.A.dtype, device=model.A.device)


@full_f32()
def koopman_kalman_filter(model: KoopmanModel, R, U, Y, q: float = 1e-6, m0=None,
                          P0=None, p0: float = 1e-2,
                          graph: Optional[bool] = None) -> FilterResult:
    """Kalman filter on the lifted linear system ``z+ = A z + B u`` of a
    fitted EDMDc model, the readout as the measurement matrix.

    ``q``/``p0`` scale the isotropic lifted process / prior covariance;
    ``m0`` defaults to lifting ``Y[0]``.  Means and covariances come back
    in the state space, projected through the readout inside the loop (the
    ``(T, d, d)`` lifted history is 48 GB at the tank recording's size).
    The readout is linear, so its Jacobian is the readout itself (equal to
    its Jacobian, tested).  All GEMMs run in full float32 (no TF32),
    the JAX package's HIGHEST precision.
    """
    A, B = model.A, model.B
    Y = torch.as_tensor(Y, device=A.device)
    R, U, m0, P0 = _tensors(A, R, U, m0, P0)
    _check_inputs(U, Y)
    d = model.lift_dim
    Hm = koopman_readout(model)
    if m0 is None:
        m0 = lift(model, Y[0])
    P0 = torch.eye(d, dtype=A.dtype, device=A.device) * p0 if P0 is None else P0
    Q = torch.eye(d, dtype=A.dtype, device=A.device) * q

    def update(z, P, y):
        delta, P_new, nis, ll = _tangent_update(y - Hm @ z, Hm, P, R)
        return z + delta, P_new, nis, ll

    def body(carry, inp):
        z, P = carry
        u, y = inp
        z_pred = A @ z + B @ u
        P_pred = _sym(A @ P @ A.T + Q)
        z, P, nis, ll = update(z_pred, P_pred, y)
        return (z, P), (Hm @ z, Hm @ P @ Hm.T, nis, ll)

    z, P, nis0, ll0 = update(m0, P0, Y[0])
    ms, Ps, niss, lls = scan(body, (z, P), (U, Y[1:]), graph=graph)
    return FilterResult(means=torch.cat([(Hm @ z)[None], ms]),
                        covs=torch.cat([(Hm @ P @ Hm.T)[None], Ps]),
                        loglik=ll0 + torch.sum(lls), nis=torch.cat([nis0[None], niss]))


# ---------------------------------------------------------------------------
# Particle filter
# ---------------------------------------------------------------------------

def pf_stream(seed: int, device, index: Optional[int] = None) -> torch.Generator:
    """The generator of :func:`particle_filter`'s draws for ``seed`` on
    ``device`` (``index``: the filter's place in a bank)."""
    entropy = [int(seed), PF_TAG] + ([] if index is None else [int(index)])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed((int(words[0]) << 32) | int(words[1]))


def _pf_core(step, h, Q, R, m0, P0, U, Y, n_particles: int, init_normals, draw,
             ess_frac: float, residual, graph, batched: bool) -> ParticleFilterResult:
    N = n_particles
    n = m0.shape[-1]
    dtype = m0.dtype
    Lq = _chol(_sym(Q))
    Lr = _chol(_sym(R))
    logdet_r = _logdet(Lr)
    Lp = _chol(_sym(P0))
    h_batch = vmap(h)
    log_n = -math.log(float(N))

    def weigh(logw, y, X):
        """Multiply the weights by the measurement likelihood: normalised
        log weights, the step's evidence increment and the ESS."""
        y_pred = h_batch(X)                                  # (N, m)
        v = y[None] - y_pred if residual is None else residual(y[None], y_pred)
        Sinv_v = _cho_solve(Lr, v.T).T
        lw = logw - 0.5 * (torch.sum(v * Sinv_v, dim=-1) + logdet_r + y.shape[0] * _LOG2PI)
        ll_inc = torch.logsumexp(lw, dim=0)
        logw = lw - ll_inc
        w = torch.exp(logw)
        return logw, ll_inc, 1.0 / torch.sum(w * w)

    def moments(logw, X):
        w = torch.exp(logw)
        mean = w @ X
        d = X - mean
        return mean, _sym((d * w[:, None]).T @ d)

    def first(m0, init, y0):
        X = m0[None] + init @ Lp.T
        logw, ll0, ess0 = weigh(torch.full((N,), log_n, dtype=dtype, device=m0.device), y0, X)
        mean0, cov0 = moments(logw, X)
        return (logw, X), (mean0, cov0, ll0, ess0)

    def body(carry, inp):
        logw, X = carry
        u, y, normals, uniform = inp
        w = torch.exp(logw)
        # both branches of JAX's lax.cond, one kept by torch.where: the
        # resampling (systematic: one uniform, a stratified comb, the
        # left-side search of the CDF) and the unchanged ensemble
        positions = (uniform + torch.arange(N, dtype=dtype, device=w.device)) / N
        idx = torch.clamp(torch.searchsorted(torch.cumsum(w, dim=0), positions), 0, N - 1)
        resample = 1.0 / torch.sum(w * w) < ess_frac * N
        X = torch.where(resample, X[idx], X)
        logw = torch.where(resample, torch.full_like(logw, log_n), logw)
        X = vmap(lambda xx: step(xx, u))(X) + normals @ Lq.T
        logw, ll_inc, ess = weigh(logw, y, X)
        mean, cov = moments(logw, X)
        return (logw, X), (mean, cov, ll_inc, ess)

    if batched:
        first, body = vmap(first), vmap(body)
        U, Y = _time_major(U), _time_major(Y)
    (logw, X), (mean0, cov0, ll0, ess0) = first(m0, init_normals, Y[0])
    ms, Ps, lls, esss = scan(body, (logw, X), (U, Y[1:]), graph=graph, draw=draw)
    res = ParticleFilterResult(means=torch.cat([mean0[None], ms]),
                               covs=torch.cat([cov0[None], Ps]),
                               loglik=ll0 + torch.sum(lls, dim=0),
                               ess=torch.cat([ess0[None], esss]))
    if batched:
        res = res._replace(means=_time_major(res.means), covs=_time_major(res.covs),
                           ess=_time_major(res.ess))
    return res


def particle_filter_from_draws(step: Callable, h: Callable, Q, R, m0, P0, U, Y,
                               init_normals, normals, uniforms, ess_frac: float = 0.5,
                               residual: Optional[Callable] = None,
                               graph: Optional[bool] = None) -> ParticleFilterResult:
    """:func:`particle_filter` on given draws: ``init_normals`` ``(N, n)``
    (the initial ensemble ``m0 + init_normals @ chol(P0)^T``), ``normals``
    ``(T-1, N, n)`` (the process noise of each step, times ``chol(Q)^T``)
    and ``uniforms`` ``(T-1,)`` (each step's resampling offset, drawn
    whether or not it resamples, as JAX splits a key every step)."""
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U, init_normals, normals, uniforms = _tensors(
        Y, Q, R, m0, P0, U, init_normals, normals, uniforms)
    _check_inputs(U, Y)
    return _pf_core(step, h, Q, R, m0, P0, U, Y, init_normals.shape[0], init_normals,
                    lambda s, e: (normals[s:e], uniforms[s:e]), ess_frac, residual,
                    graph, False)


def _draw_pf(gens, n_particles: int, n: int, dtype, device, bank: bool):
    """Per-chunk draws of the generators, time-major: the process normals
    ``(rows, N, n)`` and the resampling uniforms ``(rows,)``, each generator
    its normals first; a bank stacks its generators' on axis 1."""
    def draw(s, e):
        out = [(torch.randn((e - s, n_particles, n), generator=g, dtype=dtype, device=device),
                torch.rand((e - s,), generator=g, dtype=dtype, device=device)) for g in gens]
        if not bank:
            return out[0]
        return tuple(torch.stack([o[i] for o in out], dim=1) for i in range(2))
    return draw


def particle_filter(step: Callable, h: Callable, Q, R, m0, P0, U, Y,
                    n_particles: int = 1024, seed: int = 0, ess_frac: float = 0.5,
                    residual: Optional[Callable] = None,
                    graph: Optional[bool] = None) -> ParticleFilterResult:
    """Bootstrap particle filter (sequential Monte Carlo).

    Same ``step``/``h``/dataset contract as :func:`ekf` (additive Gaussian
    process and measurement noise ``Q``/``R``, ``Q`` positive definite);
    the posterior is a weighted ensemble of ``n_particles`` states moved
    through the full nonlinear step as one batch, weighted by the Gaussian
    measurement likelihood, and resampled systematically whenever the
    effective sample size falls below ``ess_frac * n_particles``.
    ``loglik`` is the SMC evidence estimate.  Deterministic given
    ``seed``: the draws come from :func:`pf_stream`, the initial ensemble
    first, then each chunk's process normals and resampling uniforms,
    made on the data's device as the run reaches them (so the numbers
    follow ``ops.scan.GRAPH_CHUNK``, on the graph and the eager path alike).
    """
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U = _tensors(Y, Q, R, m0, P0, U)
    _check_inputs(U, Y)
    n = m0.shape[0]
    gen = pf_stream(seed, Y.device)
    init = torch.randn((n_particles, n), generator=gen, dtype=m0.dtype, device=Y.device)
    return _pf_core(step, h, Q, R, m0, P0, U, Y, n_particles, init,
                    _draw_pf([gen], n_particles, n, m0.dtype, Y.device, False), ess_frac,
                    residual, graph, False)


def particle_filter_bank(step: Callable, h: Callable, Q, R, m0, P0, U, Y,
                         n_particles: int = 1024, seed: int = 0, ess_frac: float = 0.5,
                         residual: Optional[Callable] = None, indices=None,
                         graph: Optional[bool] = None) -> ParticleFilterResult:
    """A bank of independent particle filters, ``m0`` ``(B, n)``, ``U``
    ``(B, T-1, r)``, ``Y`` ``(B, T, m)``; filter ``b`` draws from
    ``pf_stream(seed, device, indices[b])`` (default ``indices = range(B)``),
    the twin of JAX's ``fold_in(key, b)``, so a filter's result does not
    depend on the bank it runs in."""
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U = _tensors(Y, Q, R, m0, P0, U)
    _check_inputs(U, Y, 1)
    B, n = m0.shape
    indices = range(B) if indices is None else indices
    gens = [pf_stream(seed, Y.device, int(i)) for i in indices]
    init = torch.stack([torch.randn((n_particles, n), generator=g, dtype=m0.dtype,
                                    device=Y.device) for g in gens])
    draw = _draw_pf(gens, n_particles, n, m0.dtype, Y.device, True)
    return _pf_core(step, h, Q, R, m0, P0, U, Y, n_particles, init, draw, ess_frac,
                    residual, graph, True)


# ---------------------------------------------------------------------------
# Moving-horizon estimation
# ---------------------------------------------------------------------------

def mhe(step: Callable, h: Callable, Q, R, m0, P0, U, Y, window: int = 25,
        iters: int = 20, init_iters: int = 300, lr: float = 0.05,
        meas_loss: str = "quadratic", huber_delta: float = 3.0,
        residual: Optional[Callable] = None, graph: Optional[bool] = None) -> MHEResult:
    """Moving-horizon estimation: optimisation-based state estimation.

    At each step the last ``window`` measurements are explained by an
    initial state and a process-noise sequence through the rollout, by
    Adam (``sysid.adam_update``, optax's update) from the previous
    window's shifted solution; the window's terminal state is the
    estimate.  Cost, every residual whitened by the Cholesky factors of
    ``P0``/``Q``/``R``::

        0.5 ||x_0 - prior||^2_{P0^-1} + 0.5 sum_j ||w_j||^2_{Q^-1}
            + sum_j rho( R^{-1/2} (y_j - h(x_j)) )

    with ``x_{j+1} = step(x_j, u_j) + w_j`` and ``rho`` quadratic or Huber
    (``meas_loss="huber"``, which bounds the pull of impulsive outliers).
    The decision variables are whitened (``x0 = prior + Lp e0w``, ``w_j =
    Lq ww_j``).  As in the JAX package, Adam's moments and count restart
    at every window (``optax``'s ``init`` per ``optimize`` call), the first
    window runs ``init_iters`` iterations from zero and later windows
    ``iters``; the arrival prior is the previous window's smoothed state
    at the new window start.  On the card one Adam iteration and the final
    window cost are captured as CUDA graphs and replayed.  Returns the
    first window's smoothed states, then one terminal estimate a window.
    """
    if meas_loss not in ("quadratic", "huber"):
        raise ValueError(f"unknown meas_loss {meas_loss!r}")
    Y = torch.as_tensor(Y)
    Q, R, m0, P0, U = _tensors(Y, Q, R, m0, P0, U)
    _check_inputs(U, Y)
    T = Y.shape[0]
    W = int(window)
    if not 2 <= W <= T:
        raise ValueError(f"window must be in [2, T={T}], got {W}")
    n = m0.shape[0]
    dev, dtype = Y.device, m0.dtype
    Lq, Lr, Lp = _chol(_sym(Q)), _chol(_sym(R)), _chol(_sym(P0))
    h_batch = vmap(h)

    def rho(vw):
        if meas_loss == "huber":
            a = torch.abs(vw)
            return torch.sum(torch.where(a <= huber_delta, 0.5 * a * a,
                                         huber_delta * (a - 0.5 * huber_delta)))
        return 0.5 * torch.sum(vw * vw)

    def window_cost(e0w, ww, prior, U_w, Y_w):
        x = prior + Lp @ e0w
        w_proc = ww @ Lq.T                                    # (W-1, n)
        xs = [x]
        for j in range(W - 1):
            x = step(x, U_w[j]) + w_proc[j]
            xs.append(x)
        X_w = torch.stack(xs)                                 # (W, n)
        y_pred = h_batch(X_w)
        v = Y_w - y_pred if residual is None else residual(Y_w, y_pred)
        vw = torch.linalg.solve_triangular(Lr, v.T, upper=False).T
        cost = rho(vw) + 0.5 * torch.sum(ww ** 2) + 0.5 * torch.sum(e0w ** 2)
        return cost, X_w

    # the window's state: decision variables, Adam moments and count, inputs
    e0w = torch.zeros(n, dtype=dtype, device=dev, requires_grad=True)
    ww = torch.zeros((W - 1, n), dtype=dtype, device=dev, requires_grad=True)
    leaves = [e0w, ww]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    count = torch.zeros((), dtype=torch.float64, device=dev)
    prior, U_w, Y_w = m0.clone(), U[:W - 1].clone(), Y[:W].clone()

    def iteration():
        cost, _ = window_cost(e0w, ww, prior, U_w, Y_w)
        grads = torch.autograd.grad(cost, leaves)
        sysid.adam_update(leaves, grads, mu, nu, count, lr)

    def final():
        with torch.no_grad():
            return window_cost(e0w, ww, prior, U_w, Y_w)

    def optimize(n_iters: int):
        with torch.no_grad():
            for t in mu + nu + [count]:
                t.zero_()
        for _ in range(n_iters):
            run_iteration()
        loss, X_w = run_final()
        return loss.reshape(1).clone(), X_w.clone()

    with full_f32():
        graph = use_graph(graph, dev)
        run_iteration, run_final = capture([iteration, final], leaves + mu + nu + [count], graph,
                                           warmup=sysid.GRAPH_WARMUP)
        loss0, X0_w = optimize(init_iters)
        X_prev, means, losses = X0_w, [X0_w], [loss0]
        for j in range(1, T - W + 1):
            with torch.no_grad():
                prior.copy_(X_prev[1])
                e0w.zero_()
                ww.copy_(torch.cat([ww[1:], torch.zeros_like(ww[:1])]))
                U_w.copy_(U[j:j + W - 1])
                Y_w.copy_(Y[j:j + W])
            loss_f, X_prev = optimize(iters)
            means.append(X_prev[-1:])
            losses.append(loss_f)
        if graph:
            torch.cuda.current_stream(dev).synchronize()
    return MHEResult(means=torch.cat(means), losses=torch.cat(losses))


# ---------------------------------------------------------------------------
# Noise identification
# ---------------------------------------------------------------------------

def fit_noise(step: Callable, h: Callable, m0, P0, U, Y, q0=1e-4, r0=1e-2,
              steps: int = 150, lr: float = 0.1, fit_q: bool = True, fit_r: bool = True,
              residual: Optional[Callable] = None, graph: Optional[bool] = None,
              stats: Optional[dict] = None) -> NoiseFitResult:
    """Maximum-likelihood noise covariances by gradient ascent on the
    filter's innovation log-likelihood.

    ``Q = diag(exp(log_q))`` and ``R = diag(exp(log_r))`` are fitted by the
    coefficient fit's full-batch Adam (``sysid._run_adam``), the gradient
    by autograd through the whole filter.  ``Y`` may be ``(T, m)`` or a
    bank ``(B, T, m)`` (``m0`` ``(B, n)``, ``U`` ``(B, T-1, r)``; the
    log-likelihoods sum over the bank).  ``q0``/``r0`` seed the
    log-diagonals (scalar or per channel); ``fit_q=False``/``fit_r=False``
    holds one at its seed.  The loss is the negative log-likelihood per
    measurement vector.  On the card an Adam iteration (the filter, its
    backward pass and the update) is one CUDA graph, replayed ``steps``
    times (``graph`` as in ``ops.scan.use_graph``); ``stats`` receives
    the capture's seconds and an iteration's replayed milliseconds
    (``sysid._run_adam``).
    """
    Y = torch.as_tensor(Y)
    m0, P0, U = _tensors(Y, m0, P0, U)
    if not (fit_q or fit_r):
        raise ValueError("at least one of fit_q/fit_r must be True")
    batched = Y.ndim == 3
    n, m = m0.shape[-1], Y.shape[-1]
    dtype, dev = m0.dtype, Y.device
    log_q0 = torch.log(torch.as_tensor(q0, dtype=dtype, device=dev).expand(n)).clone()
    log_r0 = torch.log(torch.as_tensor(r0, dtype=dtype, device=dev).expand(m)).clone()
    theta0 = {}
    if fit_q:
        theta0["log_q"] = log_q0
    if fit_r:
        theta0["log_r"] = log_r0
    n_meas = Y.shape[0] * Y.shape[1] if batched else Y.shape[0]

    def negll(theta, rows: Optional[int] = None):
        Q = torch.diag(torch.exp(theta.get("log_q", log_q0)))
        R = torch.diag(torch.exp(theta.get("log_r", log_r0)))
        U_r, Y_r = (U, Y) if rows is None else (U[..., :rows - 1, :], Y[..., :rows, :])
        ll = ekf(step, h, Q, R, m0, P0, U_r, Y_r, residual=residual, graph=False,
                 batched=batched).loglik
        return -torch.sum(ll) / n_meas

    graph = use_graph(graph, dev)
    if graph:
        # the capture's warm-up: the loss and its gradient over the first 3
        # rows, on a side stream (the same kernels as a whole iteration,
        # which eagerly costs the host seconds)
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            th = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
            torch.autograd.grad(negll(th, 3), list(th.values()))
        torch.cuda.current_stream(dev).wait_stream(side)
    theta, losses = sysid._run_adam(negll, theta0, steps, lr, graph=graph, warmup=0,
                                    stats=stats)
    log_q = theta.get("log_q", log_q0)
    log_r = theta.get("log_r", log_r0)
    return NoiseFitResult(Q=torch.diag(torch.exp(log_q)), R=torch.diag(torch.exp(log_r)),
                          log_q=log_q, log_r=log_r, losses=losses)


# ---------------------------------------------------------------------------
# Manifold (error-state) EKF and RTS, the quat13 box operators
# ---------------------------------------------------------------------------

def manifold_ekf(step: Callable, h: Callable, Q, R, x0, P0, U, Y, *, boxplus: Callable,
                 boxminus: Callable, residual: Optional[Callable] = None,
                 graph: Optional[bool] = None) -> FilterResult:
    """Error-state EKF on a manifold given by its retraction ``boxplus(x,
    delta)`` and its local coordinates ``boxminus(x2, x1)``; ``residual(y,
    y_pred)`` defaults to ``y - y_pred``.  Both Jacobians are exact
    derivatives of the retraction at ``delta = 0`` (:func:`_jac`): ``F =
    d/d delta boxminus(step(boxplus(x, delta), u), step(x, u))`` and ``Hm
    = -d/d delta residual(y, h(boxplus(x, delta)))``.  ``Q``/``P0`` and
    the result's ``covs`` are tangent-space ``(d, d)``.  With Euclidean
    box operators this is :func:`ekf`."""
    Y = torch.as_tensor(Y)
    Q, R, x0, P0, U = _tensors(Y, Q, R, x0, P0, U)
    _check_inputs(U, Y)
    d = Q.shape[0]
    zero_d = torch.zeros(d, dtype=P0.dtype, device=P0.device)
    res_fn = residual if residual is not None else (lambda y, yp: y - yp)

    def update(x, P, y):
        g = lambda delta: res_fn(y, h(boxplus(x, delta)))  # noqa: E731
        J, v = _jac(g, zero_d, R.shape[0])          # v(delta) ~ v(0) - Hm delta
        delta, P_new, nis, ll = _tangent_update(v, -J, P, R)
        return boxplus(x, delta), P_new, nis, ll

    def body(carry, inp):
        x, P = carry
        u, y = inp
        x_pred = step(x, u)
        F, _ = _jac(lambda delta: boxminus(step(boxplus(x, delta), u), x_pred), zero_d, d)
        P_pred = _sym(F @ P @ F.T + Q)
        x, P, nis, ll = update(x_pred, P_pred, y)
        return (x, P), (x, P, nis, ll)

    return _run_filter(update, body, x0, P0, U, Y, graph, False)


def manifold_rts_smooth(step: Callable, Q, U, filtered: FilterResult, *,
                        boxplus: Callable, boxminus: Callable,
                        graph: Optional[bool] = None) -> SmootherResult:
    """RTS backward pass in the tangent space of a :func:`manifold_ekf`
    trajectory: ``m_s = boxplus(m_f, G boxminus(m_next_s, m_pred))``; the
    Euclidean box operators give :func:`rts_smooth`.  As there, the
    predictions and Jacobians at the filtered means come from one batched
    call before the reversed scan."""
    means_f, covs_f = filtered.means, filtered.covs
    Q, U = _tensors(means_f, Q, U)
    d = Q.shape[0]
    m_f_all = means_f[:-1]
    m_pred_all = vmap(step)(m_f_all, U)
    zero = torch.zeros((m_f_all.shape[0], d), dtype=covs_f.dtype, device=covs_f.device)
    F_all, _ = _jac(lambda delta, m_f, u, m_pred: boxminus(step(boxplus(m_f, delta), u), m_pred),
                    zero, d, m_f_all, U, m_pred_all)

    def body(carry, inp):
        m_next_s, P_next_s = carry
        m_f, P_f, F, m_pred = inp
        G, P_pred, P_s = _rts_backstep(F, P_f, Q, P_next_s)
        m_s = boxplus(m_f, G @ boxminus(m_next_s, m_pred))
        return (m_s, P_s), (m_s, P_s)

    ms, Ps = scan(body, (means_f[-1], covs_f[-1]), (m_f_all, covs_f[:-1], F_all, m_pred_all),
                  graph=graph, reverse=True)
    return _smoother_result(ms, Ps, filtered)


def _quat_conjugate(q):
    # ops.quaternion.quat_conjugate multiplies by a tensor made from a
    # host list, a copy a CUDA graph cannot capture; the same bits here
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat13_boxplus(x, delta):
    """Retraction for quat13: additive position (``delta[0:3]``) and
    velocities (``delta[6:12]``), the attitude error right-multiplied as
    ``quat_exp(delta[3:6])`` (body frame)."""
    q = quat_multiply(x[..., 3:7], quat_exp(delta[..., 3:6]))
    return torch.cat([x[..., 0:3] + delta[..., 0:3], q, x[..., 7:13] + delta[..., 6:12]], dim=-1)


def quat13_boxminus(x2, x1):
    """Local coordinates of quat13 state ``x2`` around ``x1``."""
    dq = quat_log(quat_multiply(_quat_conjugate(x1[..., 3:7]), x2[..., 3:7]))
    return torch.cat([x2[..., 0:3] - x1[..., 0:3], dq, x2[..., 7:13] - x1[..., 7:13]], dim=-1)


def quat13_residual(y, y_pred):
    """Full-state quat13 measurement residual in the 12-dim tangent space."""
    return quat13_boxminus(y, y_pred)


def mekf_quat13(step, Q, R, x0, P0, U, Y, graph: Optional[bool] = None) -> FilterResult:
    """Multiplicative EKF for the quat13 wrench convention with full-state
    quat13 measurements: :func:`manifold_ekf` with the quat13 box
    operators; ``Q``/``R``/``P0`` are ``(12, 12)`` tangent-space
    covariances and ``means`` 13-dim states with unit quaternions."""
    return manifold_ekf(step, lambda x: x, Q, R, x0, P0, U, Y, boxplus=quat13_boxplus,
                        boxminus=quat13_boxminus, residual=quat13_residual, graph=graph)


# ---------------------------------------------------------------------------
# Banks and diagnostics
# ---------------------------------------------------------------------------

def segment_trajectory(U, Y, length: int):
    """Cut one recording into a bank of ``length``-step trajectories:
    ``U`` ``(T-1, r)`` / ``Y`` ``(T, m)`` become ``U_b`` ``(B, length-1,
    r)`` / ``Y_b`` ``(B, length, m)`` with ``B = T // length`` contiguous
    segments (the tail dropped), and ``m0_b`` is ``Y`` at each segment
    start.  Returns ``(m0_b, U_b, Y_b)``."""
    Y = torch.as_tensor(Y)
    (U,) = _tensors(Y, U)
    if Y.shape[0] != U.shape[0] + 1:
        raise ValueError(f"U must have T-1={Y.shape[0] - 1} rows, got {U.shape[0]}")
    if length < 2 or length > Y.shape[0]:
        raise ValueError(f"segment length {length} not in [2, {Y.shape[0]}]")
    B = Y.shape[0] // length
    Y_b = Y[: B * length].reshape(B, length, Y.shape[1])
    idx = (torch.arange(B, device=Y.device) * length)[:, None] + torch.arange(
        length - 1, device=Y.device)[None, :]
    return Y_b[:, 0], U[idx], Y_b


def nees(result: FilterResult, X_true) -> torch.Tensor:
    """Normalized estimation error squared per step; ``E[nees] = n`` for a
    consistent filter."""
    (X_true,) = _tensors(result.means, X_true)
    e = result.means - X_true
    return torch.sum(e * _cho_solve_vec(_chol(_sym(result.covs)), e), dim=-1)

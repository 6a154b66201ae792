"""Thruster actuation: T200 static curve, wrench map, third-order lag.

Counterpart of ``bluerov2_dynamics_tpu/models/thrusters.py``.  The lag
state ``(..., 8, 3)`` is explicit and advances exactly once per outer
integrator step; its output wrench is held across the RK4 stages.
"""

from __future__ import annotations

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.models.params import LagParams, ThrusterConfig


def static_thrust(cfg: ThrusterConfig, V):
    """T200 static thrust ``F(V)`` for normalised commands ``V`` in [-1, 1]:
    ``8.9 V + 176 V^3 - 404.1 V^5 + 389.9 V^7 - 140.3 V^9`` in Horner form
    on ``V^2``."""
    c1, c3, c5, c7, c9 = (cfg.curve[i] for i in range(5))
    V2 = V * V
    return V * (c1 + V2 * (c3 + V2 * (c5 + V2 * (c7 + V2 * c9))))


def wrench_from_thrust(cfg: ThrusterConfig, F):
    """Body wrench tau ``(..., 6)`` from per-thruster forces ``F (..., 8)``."""
    return F @ cfg.wrench_map


def lag_step(lag: LagParams, state, F_cmd):
    """Advance all lag filters one sample: ``x' = Ad x + Bd u``, then
    ``F = c . x'`` (the output is read after the update).

    ``state``: ``(..., 8, 3)``; ``F_cmd``: ``(..., 8)``.  Returns
    ``(new_state, F_dyn)``.
    """
    new_state = state @ lag.Ad.T + F_cmd[..., None] * lag.Bd
    F_dyn = new_state @ lag.c
    return new_state, F_dyn


def lag_history_chunked(lag: LagParams, F_cmd, chunk: int = 256, lanes: int = 32):
    """The lag states ``(N, 8, 3)`` before each of the thrusts ``F_cmd
    (N, 8)``, from rest, in the association order of the CUDA lane scans
    (``csrc/lag_history.cu``, ``csrc/rollout.cu::tau_chunk_scan``): for each
    chunk of ``chunk`` rows, each of ``lanes`` lanes runs its ``chunk //
    lanes`` rows from rest (lane 0 from the chunk's start state); an
    inclusive scan combines the lanes' maps ``x -> P x + e`` (``P =
    Ad^(chunk // lanes)`` by squaring, level ``s`` adding ``P^(2^s)`` times
    the lane ``2^s`` before); each lane then reruns its rows from the end
    state of the lane before it, keeping the state before each row, and the
    last lane's end state starts the next chunk.  ``chunk`` and ``lanes``
    are powers of two.  Plain PyTorch (a loop over chunks)."""
    N, m = F_cmd.shape[0], chunk // lanes
    AdT, Bd = lag.Ad.T, lag.Bd
    P = lag.Ad
    for _ in range(m.bit_length() - 1):
        P = P @ P
    powers = [P]
    for _ in range(lanes.bit_length() - 2):
        powers.append(powers[-1] @ powers[-1])
    hist = F_cmd.new_empty((N, 8, 3))
    carry = F_cmd.new_zeros((8, 3))
    for t0 in range(0, N, chunk):
        n = min(chunk, N - t0)
        f = F_cmd.new_zeros((lanes * m, 8))
        f[:n] = F_cmd[t0:t0 + n]
        f = f.reshape(lanes, m, 8, 1)
        # a lane past the last row advances on zeros here, where the kernels
        # skip the row: only its own (unused) states differ
        e = F_cmd.new_zeros((lanes, 8, 3))
        e[0] = carry
        for i in range(m):
            e = e @ AdT + f[:, i] * Bd          # lag_step's state update
        for s, Ps in enumerate(powers):
            d = 1 << s
            e = torch.cat([e[:d], e[:-d] @ Ps.T + e[d:]])
        x = torch.cat([carry[None], e[:-1]])
        out = []
        for i in range(m):
            out.append(x)
            x = x @ AdT + f[:, i] * Bd
        hist[t0:t0 + n] = torch.stack(out, dim=1).reshape(lanes * m, 8, 3)[:n]
        carry = x[-1]
    return hist


def init_lag_state(batch_shape=(), dtype=torch.float32, device=None):
    """Zero (at-rest) lag state of shape ``batch_shape + (8, 3)``."""
    return torch.zeros((*batch_shape, 8, 3), dtype=dtype, device=device)


def thruster_wrench(cfg: ThrusterConfig, lag: LagParams, lag_state, u8):
    """Commands -> static curve -> lag -> body wrench; returns
    ``(new_lag_state, tau)``."""
    F_cmd = static_thrust(cfg, u8)
    new_state, F_dyn = lag_step(lag, lag_state, F_cmd)
    return new_state, wrench_from_thrust(cfg, F_dyn)


def thruster_wrench_nolag(cfg: ThrusterConfig, u8):
    """Static-curve-only wrench (lag disabled)."""
    return wrench_from_thrust(cfg, static_thrust(cfg, u8))


def effective_wrench_history(cfg: ThrusterConfig, lag: LagParams, U,
                             lag_state0=None, use_lag: bool = True):
    """Per-step applied body wrench ``(N, 6)`` over commands ``U (N, 8)``.

    Entry ``k`` is the wrench during the step that consumed ``U[k]``, with
    the lag advanced once per step from at-rest filters unless
    ``lag_state0`` is given.
    """
    F_cmd = static_thrust(cfg, U)
    if not use_lag:
        return wrench_from_thrust(cfg, F_cmd)
    L = lag_state0 if lag_state0 is not None else init_lag_state(
        dtype=F_cmd.dtype, device=F_cmd.device)
    F_hist = []
    for k in range(F_cmd.shape[0]):
        L, F_dyn = lag_step(lag, L, F_cmd[k])
        F_hist.append(F_dyn)
    return wrench_from_thrust(cfg, torch.stack(F_hist))


def tf_to_ss(num, den):
    """Transfer function -> controllable-canonical state space (host-side).

    ``num``/``den`` are descending-power coefficient sequences; returns
    ``(A, B, C, D)`` numpy arrays.
    """
    num = np.atleast_1d(np.asarray(num, np.float64))
    den = np.atleast_1d(np.asarray(den, np.float64))
    den = den / den[0]
    n = len(den) - 1
    num = np.concatenate([np.zeros(n + 1 - len(num)), num / 1.0])
    d0 = num[0]
    b = num[1:] - den[1:] * d0
    A = np.zeros((n, n))
    A[0, :] = -den[1:]
    A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = b[None, :]
    D = np.array([[d0]])
    return A, B, C, D

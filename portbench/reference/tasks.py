"""What each kind of request computes, in the plain reference.

* :func:`window_rmse`: every start of a recording advanced ``H`` steps (the
  thruster model from at-rest lag filters at each start, or the wrench
  model), the endpoint RMSE against the recorded row ``H`` later.
* :func:`rollout_final`: rows advanced ``T`` steps under their own command
  sequence, the lag from rest; the smallest ``|cos(pitch)|`` each passed.
* :func:`fit`: the identification fit: 23 log-scales on the nominal
  coefficients, the mean squared multi-step error over every start of the
  training split (the lag warm-started from its history), Adam.

Each runs in the :class:`~portbench.reference.fossen.Precision` it is given,
on the device of its inputs, and imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import fossen as ref


def window_rmse(cfg: dict, X, U, H: int, method: str, prec=ref.F64, block: int = 1 << 16):
    """Endpoint ``H``-step RMSE over the ``N - H`` starts of ``X``, in blocks
    of starts."""
    X = prec.r(X.to(prec.dtype))
    U = prec.r(U.to(prec.dtype))
    h = ref.nominal_hydro(cfg, X.device, prec)
    step = ref.make_step(cfg, h, method, prec)
    act = ref.actuation(cfg, X.device, prec) if cfg["input"] == "thrusters" else None
    n = X.shape[0] - H
    sq = torch.zeros((), dtype=torch.float64, device=X.device)
    for lo in range(0, n, block):
        m = min(block, n - lo)
        x = X[lo:lo + m]
        L = torch.zeros((m, 8, 3), dtype=prec.dtype, device=X.device)
        for t in range(H):
            u = U[lo + t:lo + t + m]
            if act is not None:
                L, u = act.step(L, u, prec)
            x = step(x, u)
        d = (x - X[lo + H:lo + H + m]).double()
        sq = sq + (d * d).sum()
    return math.sqrt(float(sq) / (n * X.shape[1]))


def rollout_final(cfg: dict, x0, U, method: str, prec=ref.F64):
    """``x0 (n, 12)`` each under its own commands ``U (T, n, 8)`` (thruster
    model, the lag from rest): ``(xT (n, 12), min |cos(pitch)| (n,))``."""
    x = prec.r(x0.to(prec.dtype))
    U = prec.r(U.to(prec.dtype))
    h = ref.nominal_hydro(cfg, x.device, prec)
    step = ref.make_step(cfg, h, method, prec)
    act = ref.actuation(cfg, x.device, prec)
    L = torch.zeros((x.shape[0], 8, 3), dtype=prec.dtype, device=x.device)
    cmin = torch.cos(x[:, 4]).abs().double()
    for t in range(U.shape[0]):
        L, tau = act.step(L, U[t], prec)
        x = step(x, tau)
        cmin = torch.minimum(cmin, torch.cos(x[:, 4]).abs().double())
    return x, cmin


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding with its gradient rounded too (the control's fit)."""

    @staticmethod
    def forward(ctx, t):
        return ref.round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return ref.round_tf32(g)


def _differentiable(prec):
    return prec if prec.rnd is None else prec._replace(rnd=_RoundTF32.apply)


def lag_history(cfg: dict, U: np.ndarray) -> np.ndarray:
    """``(N, 8, 3)`` lag states before each command of ``U (N, 8)``, from rest
    (float64, host)."""
    act = ref.actuation(cfg, "cpu")
    Ad, Bd = act.Ad.numpy(), act.Bd.numpy()
    F = act.thrust(torch.as_tensor(U, dtype=torch.float64)).numpy()
    out = np.empty((U.shape[0], 8, 3))
    L = np.zeros((8, 3))
    AdT = Ad.T
    for k in range(U.shape[0]):
        out[k] = L
        L = L @ AdT + F[k][:, None] * Bd
    return out


def fit(cfg: dict, X, U, horizon: int, steps: int, lr: float, method: str, input_delay: int,
        lag0=None, prec=ref.F64, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam over the 23 log-scales from zero: ``(losses (steps,), theta (23,),
    first gradient (23,))``, each loss taken at the parameters its step
    starts from.  ``lag0 (n_start, 8, 3)``: the lag state each start
    carries (at rest where None)."""
    prec = _differentiable(prec)
    dev = X.device
    X = prec.r(X.to(prec.dtype))
    U = prec.r(U.to(prec.dtype))
    n = X.shape[0] - horizon - input_delay
    act = ref.actuation(cfg, dev, prec)
    L0 = (torch.zeros((n, 8, 3), dtype=prec.dtype, device=dev) if lag0 is None
          else prec.r(lag0.to(dev, prec.dtype)))
    nominal = torch.tensor(ref.nominal_coefficients(cfg), dtype=torch.float64,
                           device=dev).to(prec.dtype)
    theta = torch.zeros(ref.N_COEFFS, dtype=prec.dtype, device=dev, requires_grad=True)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    losses, g0 = [], None

    def loss_fn():
        h = ref.hydro(cfg, prec.r(nominal * torch.exp(theta)), prec)
        step = ref.make_step(cfg, h, method, prec)
        x, L = X[:n], L0
        errs = []
        for t in range(horizon):
            u = U[t + input_delay:t + input_delay + n]
            L, tau = act.step(L, u, prec)
            x = step(x, tau)
            d = x - X[t + 1:t + 1 + n]
            errs.append(prec.r(torch.mean(d * d)))
        return torch.stack(errs).mean()

    for k in range(steps):
        loss = loss_fn()
        (g,) = torch.autograd.grad(loss, [theta])
        losses.append(float(loss.detach()))
        if g0 is None:
            g0 = g.detach().clone()
        with torch.no_grad():
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            mhat = mu / (1 - b1 ** (k + 1))
            vhat = nu / (1 - b2 ** (k + 1))
            theta.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    return np.asarray(losses), theta.detach().double().cpu().numpy(), g0.double().cpu().numpy()

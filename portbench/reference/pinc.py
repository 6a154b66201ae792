"""Plain reference of PINc training, from a configuration's numbers.

PINc is the physics-informed residual network of ViktorNfa/bluerov2_dynamics
(``training/train_tank_brov2_full_comparison.py:598-888``): a one-step
integrator ``x9' = head(x9, MLP([x9, u4, dt]))`` on the reduced state
``[x, y, z, cos psi, sin psi, u, v, w, r]`` under the body wrench ``[X, Y,
Z, Mz]``.  Written here from that description and the configuration file,
not from the port, as plain tensor arithmetic on a flat list of
parameters:

* a hidden layer is ``Linear``, the adaptive softplus ``logaddexp(beta x,
  0) / (beta + 1e-12)`` with a learnable scalar ``beta``, then a LayerNorm
  of the fast variance ``max(E[x^2] - E[x]^2, 0)``; the output ``Linear``
  gives the residual, whose x and y are rotated by the input yaw, and
  ``(cos psi, sin psi)`` is renormalised with a floor;
* the loss is the one-step MSE, the mean square of the reduced model's
  right-hand side at the prediction (``physics_weight``), and the mean
  over ``steps`` of the open-loop MSE from the first row of each window
  (``rollout_weight``);
* the update is a global-norm clip, then AdamW (bias-corrected moments,
  epsilon outside the square root, decoupled weight decay).

Departures from the published script, each the port's and stated in the
configuration's ``assumed``: the physics term keeps its gradient, the
rollout windows are consecutive rows, and the LayerNorm epsilon is 1e-6.

The dataset comes from the recording through ``fossen.py``'s own T200
curve, ZOH lag and wrench map.  Everything runs in the
:class:`~portbench.reference.fossen.Precision` it is given (the control
rounds each intermediate and each gradient to TF32), on the device of its
inputs, and imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fossen as ref
from portbench.reference import tasks as rt

WRENCH4 = (0, 1, 2, 5)        # Fx, Fy, Fz, Mz of the body wrench
PER_HIDDEN = 5                # W, b, beta, LayerNorm scale and bias


def param_shapes(cfg: dict) -> list:
    """Shapes of the flat parameter list: per hidden layer ``W (h, in)``,
    ``b (h,)``, ``beta ()``, scale ``(h,)``, bias ``(h,)``; then the output
    layer's ``W (9, h)``, ``b (9,)``."""
    net = cfg["pinc"]
    shapes, width = [], int(net["input_width"])
    for h in net["hidden"]:
        shapes += [(h, width), (h,), (), (h,), (h,)]
        width = h
    return shapes + [(int(net["output_width"]), width), (int(net["output_width"]),)]


def _check(cfg: dict):
    tr = cfg["training"]
    if tr["normalize"] or tr["position_invariant"] or tr["lr_schedule"] != "const":
        raise NotImplementedError("the reference trains the raw input at a constant rate only")


def reduced_rhs(cfg: dict, x9, u4, prec=ref.F64):
    """``x9_dot`` of the reduced model under ``u4``, from the configuration's
    ``reduced`` coefficients (buoyancy ``rho g volume``), as the published
    script writes it, signs included."""
    c = cfg["reduced"]
    r = prec.r
    m, g = c["m"], cfg["g"]
    buoy = c["rho"] * c["volume"] * g
    cpsi, spsi, u, v, w, yr = (x9[:, k] for k in (3, 4, 5, 6, 7, 8))
    X, Y, Z, Mz = u4.unbind(-1)
    u_d = r((X + (m - c["Y_vd"]) * v * yr + (c["X_u"] + c["X_uc"] * u.abs()) * u)
            / (m - c["X_ud"]))
    v_d = r((Y - (m - c["X_ud"]) * u * yr + (c["Y_v"] + c["Y_vc"] * v.abs()) * v)
            / (m - c["Y_vd"]))
    w_d = r((Z + (c["Z_w"] + c["Z_wc"] * w.abs()) * w + m * g - buoy) / (m - c["Z_wd"]))
    r_d = r((Mz - (c["X_ud"] - c["Y_vd"]) * u * v + (c["N_r"] + c["N_rc"] * yr.abs()) * yr)
            / (c["I_zz"] - c["N_rd"]))
    return torch.stack([r(cpsi * u - spsi * v), r(spsi * u + cpsi * v), w, r(-spsi * yr),
                        r(cpsi * yr), u_d, v_d, w_d, r_d], dim=-1)


def forward(cfg: dict, params: list, z, prec=ref.F64):
    """The net's next reduced state of each row of ``z (n, 14)``."""
    net = cfg["pinc"]
    eps, floor = float(net["ln_eps"]), float(net["cos_sin_floor"])
    r = prec.r
    h = z
    n_hidden = len(net["hidden"])
    for i in range(n_hidden):
        W, b, beta, scale, shift = params[PER_HIDDEN * i:PER_HIDDEN * (i + 1)]
        h = r(r(h @ W.T) + b)
        y = r(beta * h)
        h = r(r(torch.logaddexp(y, torch.zeros_like(y))) / (beta + 1e-12))
        mu = r(h.mean(dim=-1, keepdim=True))
        var = r(torch.clamp_min(r(r(h * h).mean(dim=-1, keepdim=True)) - r(mu * mu), 0.0))
        h = r(r(r(h - mu) * r(torch.rsqrt(var + eps) * scale)) + shift)
    W, b = params[PER_HIDDEN * n_hidden:]
    dx = r(r(h @ W.T) + b)
    x9, cpsi, spsi = z[:, :9], z[:, 3], z[:, 4]
    dxw = r(r(cpsi * dx[:, 0]) - r(spsi * dx[:, 1]))
    dyw = r(r(spsi * dx[:, 0]) + r(cpsi * dx[:, 1]))
    base = r(x9 + dx)
    c, s = base[:, 3], base[:, 4]
    norm = r(torch.clamp_min(torch.sqrt(r(r(c * c) + r(s * s))), floor))
    return torch.cat([r(x9[:, 0] + dxw)[:, None], r(x9[:, 1] + dyw)[:, None], base[:, 2:3],
                      r(c / norm)[:, None], r(s / norm)[:, None], base[:, 5:9]], dim=-1)


def _mse(a, b, prec):
    d = prec.r(a - b)
    return prec.r(torch.mean(prec.r(d * d)))


def losses(cfg: dict, params: list, z_b, y_b, u4_b, z_win, steps: int, prec=ref.F64):
    """``(mse, physics, rollout)`` of one minibatch: rows ``z_b`` with
    targets ``y_b`` and wrenches ``u4_b``, and windows ``z_win (W, steps +
    1, 14)`` of consecutive rows."""
    pred = forward(cfg, params, z_b, prec)
    mse = _mse(pred, y_b, prec)
    phys = prec.r(torch.mean(prec.r(reduced_rhs(cfg, pred, u4_b, prec) ** 2)))
    x, dt = z_win[:, 0, :9], z_win[:, 0, 13:14]
    per_step = []
    for i in range(steps):
        x = forward(cfg, params, torch.cat([x, z_win[:, i, 9:13], dt], dim=-1), prec)
        per_step.append(_mse(x, z_win[:, i + 1, :9], prec))
    return mse, phys, prec.r(torch.stack(per_step).mean())


def total_loss(cfg: dict, parts, prec=ref.F64):
    tr = cfg["training"]
    mse, phys, roll = parts
    return prec.r(prec.r(mse + tr["physics_weight"] * phys) + tr["rollout_weight"] * roll)


def adamw_clip(cfg: dict, params: list, grads: list, mu: list, nu: list, count: int,
               prec=ref.F64):
    """One clipped AdamW update of ``params`` in place (``count`` from 1)."""
    tr = cfg["training"]
    r = prec.r
    b1, b2, eps = tr["b1"], tr["b2"], tr["eps"]
    norm = torch.sqrt(r(sum(r(torch.sum(r(g * g))) for g in grads)))
    clip = tr["clip_norm"]
    if float(norm) >= clip:
        grads = [r(r(g / norm) * clip) for g in grads]
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_(r(r((1.0 - b1) * g) + r(b1 * m)))
        v.copy_(r(r((1.0 - b2) * r(g * g)) + r(b2 * v)))
        update = r(r(m / bc1) / r(torch.sqrt(r(v / bc2)) + eps))
        p.sub_(r(tr["lr"] * r(update + r(tr["weight_decay"] * p))))


def dataset(cfg: dict, X, U, prec=ref.F64):
    """``(z (N-1, 14), y (N-1, 9), u4 (N-1, 4))``: each row's reduced state,
    the wrench during its step (the lag from rest, advanced once a row) and
    dt, with the next row's reduced state."""
    dev = X.device
    hist = rt.lag_history(cfg, U.double().cpu().numpy())          # lag before each row
    act = ref.actuation(cfg, dev, prec)
    L = prec.r(torch.as_tensor(hist, device=dev).to(prec.dtype))
    _, tau = act.step(L, prec.r(U.to(dev, prec.dtype)), prec)
    u4 = tau[:, list(WRENCH4)]
    X = prec.r(X.to(prec.dtype))
    psi = X[:, 5]
    x9 = torch.cat([X[:, 0:3], prec.r(torch.cos(psi))[:, None], prec.r(torch.sin(psi))[:, None],
                    X[:, 6:9], X[:, 11:12]], dim=-1)
    dt = torch.full((X.shape[0] - 1, 1), float(cfg["dt"]), dtype=prec.dtype, device=dev)
    return torch.cat([x9[:-1], u4[:-1], dt], dim=-1), x9[1:], u4[:-1]


def train(cfg: dict, params0: list, data, draws, steps: int, prec=ref.F64):
    """Epochs from ``params0``, one for each ``(perm (B, batch), starts (B,
    W))`` of ``draws`` (minibatch rows and window starts), the optimiser's
    state carried across them: ``(each epoch's mean minibatch loss, the
    trained parameters)``, each loss taken before its update."""
    _check(cfg)
    prec = rt._differentiable(prec)
    z, y, u4 = data
    dev = z.device
    params = [prec.r(p.to(dev, prec.dtype)).clone().requires_grad_(True) for p in params0]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    offsets = torch.arange(steps + 1, device=dev)
    history, count = [], 0
    for perm, starts in draws:
        perm, starts = perm.to(dev), starts.to(dev)
        epoch = []
        for k in range(perm.shape[0]):
            idx, widx = perm[k], starts[k][:, None] + offsets
            loss = total_loss(cfg, losses(cfg, params, z[idx], y[idx], u4[idx], z[widx], steps,
                                          prec), prec)
            grads = [prec.r(g) for g in torch.autograd.grad(loss, params)]
            epoch.append(loss.detach())
            count += 1
            with torch.no_grad():
                adamw_clip(cfg, params, grads, mu, nu, count, prec)
        history.append(float(torch.stack(epoch).double().mean()))
    return history, [p.detach() for p in params]


def flat(params: list) -> np.ndarray:
    """Every parameter in one float64 host vector, in the list's order."""
    return torch.cat([p.detach().reshape(-1).double().cpu() for p in params]).numpy()


def unflat(cfg: dict, vec: np.ndarray, device) -> list:
    """The flat vector of :func:`flat` as the parameter list, float64 on ``device``."""
    out, at = [], 0
    for shape in param_shapes(cfg):
        n = int(np.prod(shape))
        out.append(torch.as_tensor(vec[at:at + n].reshape(shape), device=device))
        at += n
    if at != vec.size:
        raise ValueError(f"{vec.size} parameters for a net of {at}")
    return out

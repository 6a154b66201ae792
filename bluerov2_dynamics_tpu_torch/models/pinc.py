"""PINc: physics-informed residual one-step dynamics network (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/pinc.py`` (flax and optax
there): a residual integrator ``x_{k+1} = x_k + f_theta([x_k, u_k, dt])``
on the reduced 9-state ``[x, y, z, cos psi, sin psi, u, v, w, r]`` under
the 4-input body wrench ``[X, Y, Z, Mz]``; an MLP (64, 64, 64, 64) of
``Linear``, learnable-beta :class:`AdaptiveSoftplus` and a LayerNorm, a
yaw-rotated xy residual head and the (cos, sin) pair renormalised.
Training: AdamW(3e-3) after a global-norm clip at 5.0, loss = MSE + 0.5 *
physics residual + a multi-step rollout loss over consecutive windows.

What the port keeps of flax and optax, written out here:

* flax's ``LayerNorm`` takes the fast variance ``E[x^2] - E[x]^2``
  clipped at 0, with epsilon 1e-6 (:class:`FastVarLayerNorm`; a reference
  ``.pt`` import uses torch's 1e-5);
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``;
* kernels start truncated-normal LeCun, biases at 0, beta at 1, the
  LayerNorm scale at 1 (:func:`init_params`, from a ``torch.Generator``:
  the stream is not threefry, so a port-trained net does not repeat a
  JAX-trained one bit for bit);
* ``optax.chain(clip_by_global_norm, adamw)`` with optax's AdamW
  (weight decay 1e-4, epsilon added outside the square root), its clip
  (scaled by ``max_norm / norm`` only when ``norm >= max_norm``) and its
  warmup-cosine schedule, whose first update has learning rate 0
  (:class:`AdamWClip`).

The epoch takes its random draws as arguments (:func:`train_from_draws`,
:func:`train_epoch`), so that the JAX package's draws can be fed to it.
On one CUDA device a minibatch step (the gather, the losses, the
backward, the clip and the update) is captured once as a CUDA graph and
replayed for every minibatch of the call; on the CPU and under a mesh
the steps run eagerly, one after another.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.models.fossen import reduced_rhs
from bluerov2_dynamics_tpu_torch.models.params import (
    LagParams,
    ReducedParams,
    ThrusterConfig,
    reduced_params,
)
from bluerov2_dynamics_tpu_torch.models.thrusters import effective_wrench_history
from bluerov2_dynamics_tpu_torch.ops.integrators import rollout
from bluerov2_dynamics_tpu_torch.ops.rotations import ssa
from bluerov2_dynamics_tpu_torch.ops.scan import capture, use_graph
from bluerov2_dynamics_tpu_torch.utils.profiling import span

# the wrench components of the reduced model: Fx, Fy, Fz, Mz
WRENCH4_COLS = (0, 1, 2, 5)
# flax's LeCun normal: unit variance over fan_in, truncated at 2 standard
# deviations, whose own standard deviation this constant undoes
_TRUNC_STD = 0.87962566103423978
GRAPH_WARMUP = 1    # minibatch steps run on a side stream before the step's capture
# minibatches that train_epoch has run since import: as replays of a
# captured step and eagerly
STEPS = {"replayed": 0, "eager": 0}


# ---------------------------------------------------------------------------
# State conversions 12D <-> 9D
# ---------------------------------------------------------------------------

def state12_to_9(x12):
    """``[x,y,z,phi,theta,psi,u,v,w,p,q,r] -> [x,y,z,cos psi,sin psi,u,v,w,r]``."""
    psi = x12[..., 5]
    return torch.cat([x12[..., 0:3], torch.stack([torch.cos(psi), torch.sin(psi)], dim=-1),
                      x12[..., 6:9], x12[..., 11:12]], dim=-1)


def state9_to_12(x9):
    """The inverse embedding: psi from atan2, phi, theta, p and q zero."""
    psi = torch.atan2(x9[..., 4], x9[..., 3])
    zeros2 = torch.zeros_like(x9[..., 0:2])
    return torch.cat([x9[..., 0:3], zeros2, psi[..., None], x9[..., 5:8], zeros2,
                      x9[..., 8:9]], dim=-1)


def wrench4_from_thrusters(cfg: ThrusterConfig, lag: LagParams, U8):
    """A whole command trajectory ``U8 (T, 8)`` to 4-D body wrenches
    ``(T, 4)`` = [Fx, Fy, Fz, Mz]: the curve, then a time loop of the lag
    from at-rest filters (advanced once a row), then the wrench map."""
    return effective_wrench_history(cfg, lag, U8)[..., list(WRENCH4_COLS)]


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

class AdaptiveSoftplus(nn.Module):
    """``softplus(beta x) / beta`` with a learnable scalar beta;
    ``softplus(y) = logaddexp(y, 0)`` as ``jax.nn.softplus`` computes it."""

    def __init__(self, beta_init: float = 1.0):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(float(beta_init)))

    def forward(self, x):
        beta = self.beta
        y = beta * x
        return torch.logaddexp(y, torch.zeros((), dtype=y.dtype, device=y.device)) / (beta + 1e-12)


class FastVarLayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis: the variance is
    ``max(E[x^2] - E[x]^2, 0)``, then ``(x - E[x]) * (rsqrt(var + eps) *
    scale) + bias``.  ``weight``/``bias`` are named as torch's LayerNorm
    names them, so that a reference state dict loads as it is."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        mu2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class PINcNet(nn.Module):
    """Residual one-step integrator on the reduced 9-state.

    Input ``z = [x9, u4, dt]`` of width 14; output the next 9-state.  The
    layers sit in ``self.net`` as the reference's ``nn.Sequential`` holds
    them (``[Linear, AdaptiveSoftplus, LayerNorm]`` a hidden layer, then
    the output ``Linear``), so its state-dict keys are the reference's.

    ``norm_mu``/``norm_sigma`` (14 values, kept in float64 and cast to the
    input's dtype in the forward) standardise the MLP input;
    ``position_invariant`` multiplies x, y, z by 0 before it (a NaN
    position stays NaN).  The residual head works on the raw state.
    """

    def __init__(self, hidden: Sequence[int] = (64, 64, 64, 64), norm_mu=None, norm_sigma=None,
                 position_invariant: bool = False, ln_eps: float = 1e-6):
        super().__init__()
        layers, width = [], 14
        for h in hidden:
            layers += [nn.Linear(width, h), AdaptiveSoftplus(), FastVarLayerNorm(h, ln_eps)]
            width = h
        layers.append(nn.Linear(width, 9))
        self.net = nn.Sequential(*layers)
        self.hidden = tuple(int(h) for h in hidden)
        self.norm_mu = None if norm_mu is None else np.asarray(norm_mu, np.float64).reshape(14)
        self.norm_sigma = (None if norm_sigma is None
                           else np.asarray(norm_sigma, np.float64).reshape(14))
        self.position_invariant = bool(position_invariant)
        self.ln_eps = float(ln_eps)
        self._consts = {}

    def _input_consts(self, z):
        """``(mask, mu, sigma)`` in ``z``'s dtype on its device, made once."""
        key = (z.dtype, z.device)
        if key not in self._consts:
            put = lambda a: torch.as_tensor(a, dtype=z.dtype, device=z.device)  # noqa: E731
            self._consts[key] = (
                put([0.0] * 3 + [1.0] * 11),
                None if self.norm_mu is None else put(self.norm_mu),
                None if self.norm_sigma is None else put(self.norm_sigma),
            )
        return self._consts[key]

    def forward(self, z):
        mask, mu, sigma = self._input_consts(z)
        h = z * mask if self.position_invariant else z
        if mu is not None:
            h = (h - mu) / sigma
        dx = self.net(h)

        x9 = z[..., :9]
        cpsi, spsi = z[..., 3], z[..., 4]
        dx_wx = cpsi * dx[..., 0] - spsi * dx[..., 1]
        dx_wy = spsi * dx[..., 0] + cpsi * dx[..., 1]
        base = x9 + dx
        c, s = base[..., 3], base[..., 4]
        norm = torch.clamp_min(torch.sqrt(c * c + s * s), 1e-6)
        return torch.cat([(x9[..., 0] + dx_wx)[..., None], (x9[..., 1] + dx_wy)[..., None],
                          base[..., 2:3], (c / norm)[..., None], (s / norm)[..., None],
                          base[..., 5:9]], dim=-1)


def load_checked(net: PINcNet, sd, what: str) -> PINcNet:
    """Load the state dict ``sd`` (tensors or numpy arrays) into ``net``;
    keys or shapes that differ from the net's raise ``ValueError``."""
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(np.shape(sd[k])) for k in want if k in sd}
    if got != want:
        raise ValueError(f"{what} does not match PINcNet(hidden={net.hidden}): "
                         f"expected {want}, got {got}")
    net.load_state_dict({k: sd[k] if isinstance(sd[k], torch.Tensor)
                         else torch.from_numpy(np.array(sd[k])) for k in want})
    return net


def linears(net: PINcNet):
    """The net's ``Linear`` layers, the output layer last."""
    return [m for m in net.net if isinstance(m, nn.Linear)]


def init_params(generator: Optional[torch.Generator], hidden: Sequence[int] = (64, 64, 64, 64),
                dtype=torch.float32, norm_mu=None, norm_sigma=None,
                position_invariant: bool = False, ln_eps: float = 1e-6, device=None) -> PINcNet:
    """A new :class:`PINcNet` with flax's initialisers, drawn from
    ``generator`` (on its device; ``device`` defaults to it): each kernel
    truncated-normal LeCun (``N(0, 1/fan_in)`` cut at 2 standard
    deviations, rescaled), biases 0, beta 1, LayerNorm scale 1, bias 0."""
    if device is None:
        device = generator.device if generator is not None else torch.device("cpu")
    net = PINcNet(hidden, norm_mu, norm_sigma, position_invariant, ln_eps).to(device)
    with torch.no_grad():
        for lin in linears(net):
            nn.init.trunc_normal_(lin.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            lin.weight.mul_(math.sqrt(1.0 / lin.in_features) / _TRUNC_STD)
            lin.bias.zero_()
    return net.to(dtype)


def input_stats(z, eps: float = 1e-6):
    """Per-column mean and population standard deviation (ddof 0, floored
    at ``eps``: the constant dt column) of the training inputs, as numpy
    arrays in ``z``'s dtype."""
    mu = z.mean(dim=0)
    sigma = torch.clamp_min(z.std(dim=0, correction=0), eps)
    return mu.detach().cpu().numpy(), sigma.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def mse_loss(pred, target):
    d = pred - target
    return torch.mean(d * d)


def physics_loss(rp: ReducedParams, x_next_pred, u4, stop_gradient: bool = False):
    """Mean square of the continuous reduced RHS at the predicted next
    state; ``stop_gradient`` makes it a constant of the parameters, as the
    reference computes it."""
    val = torch.mean(reduced_rhs(rp, x_next_pred, u4) ** 2)
    return val.detach() if stop_gradient else val


def rollout_loss(net: PINcNet, z_windows, steps: int):
    """Multi-step open-loop loss over consecutive windows ``z_windows
    (B, steps+1, 14)``: from each window's first state, ``steps`` steps on
    the recorded inputs, the per-step MSE against the recorded states,
    averaged over the steps."""
    x = z_windows[:, 0, :9]
    dt_col = z_windows[:, 0, 13:14]
    losses = []
    for i in range(steps):
        x = net(torch.cat([x, z_windows[:, i, 9:13], dt_col], dim=-1))
        losses.append(mse_loss(x, z_windows[:, i + 1, :9]))
    return torch.stack(losses).mean()


# ---------------------------------------------------------------------------
# Dataset and training
# ---------------------------------------------------------------------------

class PINcData(NamedTuple):
    z: torch.Tensor   # (N-1, 14) [x9_k, u4_k, dt]
    y: torch.Tensor   # (N-1, 9)  x9_{k+1}
    u4: torch.Tensor  # (N-1, 4)


def make_dataset(X12, U8, dt, cfg: ThrusterConfig, lag: LagParams) -> PINcData:
    """``(x9_k, u4_k, dt) -> x9_{k+1}`` training pairs of a recording."""
    X9 = state12_to_9(X12)
    U4 = wrench4_from_thrusters(cfg, lag, U8)
    dts = torch.full((X9.shape[0] - 1, 1), float(dt), dtype=X9.dtype, device=X9.device)
    z = torch.cat([X9[:-1], U4[:-1], dts], dim=-1)
    return PINcData(z=z, y=X9[1:], u4=U4[:-1])


class TrainConfig(NamedTuple):
    epochs: int = 200
    batch: int = 256
    lr: float = 3e-3
    clip_norm: float = 5.0
    physics_weight: float = 0.5
    physics_stop_gradient: bool = False
    rollout_steps: int = 10
    rollout_windows: int = 16   # windows per batch for the rollout loss
    rollout_weight: float = 1.0
    normalize: bool = False     # standardize MLP inputs
    position_invariant: bool = False  # mask x,y,z from the MLP input
    lr_schedule: str = "const"  # "const" (reference) or "cosine"


def warmup_cosine_schedule(peak: float, total_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, peak, max(total // 20, 1),
    total, 0.01 peak)`` as ``count -> learning rate`` in float64: a linear
    warmup from 0 (so the first update, count 0, has rate 0), then a
    cosine decay to ``0.01 peak`` at ``total_steps``."""
    warmup = max(total_steps // 20, 1)
    decay = total_steps - warmup
    if not decay > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay}.")
    alpha = 0.01 * peak / peak if peak != 0.0 else 0.0    # optax's end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1 - min(max(count, 0), warmup) / warmup
            return (0.0 - peak) * frac + peak
        c = min(float(count - warmup), float(decay))
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return peak * ((1 - alpha) * cosine + alpha)

    return schedule


class AdamWClip:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr))`` written
    out, step for step: the global norm over every gradient, the clip
    ``(g / norm) * clip_norm`` only where ``norm >= clip_norm``; Adam's
    moments ``(1 - b) g^k + b m``, bias-corrected by ``1 - b^count`` (in
    float64, then cast), ``m / (sqrt(v) + eps)``, plus ``weight_decay *
    param``, times ``-lr(count)`` (count from 0), added to the parameter.
    ``lr`` is a float or a sequence of rates indexed by the count, the last
    holding for every later count.  The count (a 0-d float64 tensor), the
    rates and the bias corrections live on the parameters' device (of one
    dtype), so that a step reads nothing back and replays in a CUDA
    graph."""

    def __init__(self, params, lr, clip_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params = list(params)
        device = self.params[0].device if self.params else None
        self.rates = torch.as_tensor(lr, dtype=torch.float64, device=device).reshape(-1)
        self.clip_norm = float(clip_norm)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.float64, device=device)

    @torch.no_grad()
    def step(self, grads) -> None:
        """Apply one update from ``grads`` (one tensor a parameter)."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.clip_norm
        grads = [torch.where(keep, g, (g / g_norm) * self.clip_norm) for g in grads]
        dtype = self.params[0].dtype
        at = torch.clamp_max(self.count, self.rates.numel() - 1).long()
        step_size = -torch.take(self.rates, at).to(dtype)
        self.count.add_(1.0)
        bc1, bc2 = ((1 - torch.pow(b, self.count)).to(dtype) for b in (self.b1, self.b2))
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(step_size * (update + self.weight_decay * p))


def make_optimizer(tc: TrainConfig, params, total_steps: Optional[int] = None) -> AdamWClip:
    """AdamW after a global-norm clip at ``tc.clip_norm``; with
    ``tc.lr_schedule == "cosine"`` and ``total_steps``, the learning rate
    follows :func:`warmup_cosine_schedule` (its ``total_steps + 1`` rates,
    the last the end value), else it is ``tc.lr``."""
    if tc.lr_schedule == "cosine" and total_steps:
        schedule = warmup_cosine_schedule(tc.lr, total_steps)
        return AdamWClip(params, [schedule(c) for c in range(total_steps + 1)], tc.clip_norm)
    return AdamWClip(params, tc.lr, tc.clip_norm)


class _DataParallel(NamedTuple):
    """One rank's part of a data-parallel step."""
    group: object
    world: int
    rank: int
    shard_windows: bool


def _loss(net, tc: TrainConfig, rp, use_rollout, z_b, y_b, u4_b, z_win):
    pred = net(z_b)
    loss = mse_loss(pred, y_b)
    if tc.physics_weight > 0:
        loss = loss + tc.physics_weight * physics_loss(rp, pred, u4_b, tc.physics_stop_gradient)
    if use_rollout:
        loss = loss + tc.rollout_weight * rollout_loss(net, z_win, tc.rollout_steps)
    return loss


def _unnamed(name: str):
    """No span: a captured body's spans would be recorded once by the
    capture and never by a replay (``utils/profiling.py::span``)."""
    return contextlib.nullcontext()


def _step(net: PINcNet, opt: AdamWClip, data: PINcData, idx, widx, tc: TrainConfig,
          rp: ReducedParams, use_rollout: bool, dp: Optional[_DataParallel] = None, named=span):
    """One minibatch: the rows ``idx`` and the windows' rows ``widx``
    gathered, the loss, its gradient (averaged over the ranks under ``dp``,
    with the loss) and ``opt``'s update; returns the loss, detached.
    ``named`` makes the three spans (:func:`train_epoch`)."""
    with named("brov2.pinc.loss"):
        loss = _loss(net, tc, rp, use_rollout, data.z[idx], data.y[idx], data.u4[idx],
                     data.z[widx] if use_rollout else None)
    params = opt.params
    with named("brov2.pinc.grad"):
        grads = torch.autograd.grad(loss, params)
    loss = loss.detach()
    if dp is not None:
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=dp.group)
        flat = flat / dp.world
        grads = [g.view_as(p) for g, p in zip(flat[:-1].split([p.numel() for p in params]),
                                               params)]
        loss = flat[-1]
    with named("brov2.pinc.optim"):
        opt.step(grads)
    return loss


class _CapturedStep:
    """:func:`_step` of one net, optimiser and dataset on one CUDA device,
    as a CUDA graph: called with a minibatch's row indices and window
    starts, it copies them into static buffers and replays the graph, which
    gathers the rows, runs the forward, the backward, the clip and the
    update on the net's own parameters and the optimiser's own moments and
    count, and leaves the loss in a static tensor, which it returns.

    The first call captures the step (``ops.scan.capture``: ``GRAPH_WARMUP``
    steps on a side stream, their changes undone, then the capture), and
    so does a call with minibatches of another shape.  In a profiler's
    trace the warm-up and capture are the span ``brov2.pinc.capture``, and
    everything from the first replay to :meth:`close`'s synchronise the
    span ``brov2.pinc.replay``."""

    def __init__(self, net, opt, data, tc, rp, use_rollout):
        self.args = (net, opt, data, tc, rp, use_rollout)
        self.offsets = torch.arange(tc.rollout_steps + 1, device=data.z.device)
        self.shape = None
        self.replaying = contextlib.ExitStack()

    def __call__(self, idx, starts):
        if self.shape != (idx.shape, starts.shape):
            self._capture(idx, starts)
        self.idx.copy_(idx)
        self.starts.copy_(starts)
        return self.run()

    def _capture(self, idx, starts):
        net, opt, data, tc, rp, use_rollout = self.args
        first = self.shape is None
        self.idx, self.starts = idx.clone(), starts.clone()

        def body():
            return _step(net, opt, data, self.idx, self.starts[:, None] + self.offsets, tc, rp,
                         use_rollout, named=_unnamed)

        with span("brov2.pinc.capture"):
            (self.run,) = capture([body], [*opt.params, *opt.mu, *opt.nu, opt.count], True,
                                  warmup=GRAPH_WARMUP)
        self.shape = (idx.shape, starts.shape)
        if first:
            self.replaying.enter_context(span("brov2.pinc.replay"))

    def close(self) -> None:
        """Wait for the replays, end the replay span and release the graph."""
        if self.shape is not None:
            torch.cuda.current_stream(self.idx.device).synchronize()
        self.replaying.close()
        self.shape = self.run = None


def train_epoch(net: PINcNet, opt: AdamWClip, data: PINcData, perm, starts, tc: TrainConfig,
                rp: ReducedParams, use_rollout: bool, dp: Optional[_DataParallel] = None,
                graph: Optional[_CapturedStep] = None):
    """One epoch on given draws: ``perm (n_batches, batch)`` row indices and
    ``starts (n_batches, W)`` window starts.  Returns the mean minibatch
    loss (a 0-d tensor on the data's device, not read back).

    Under ``dp`` each rank takes its contiguous block of every minibatch
    (and of the windows, when they divide over the ranks; else every rank
    takes them all), and the gradients and losses are averaged over the
    ranks: the gradient of the one global loss, each term counted once.

    With ``graph`` (this net's and optimiser's :class:`_CapturedStep`, no
    ``dp``) each minibatch is a replay of the captured step.  Otherwise it
    runs eagerly, as three spans in a profiler's trace:
    ``brov2.pinc.loss`` (the gather and the loss), ``brov2.pinc.grad``
    (the backward) and ``brov2.pinc.optim`` (the update); the all-reduce
    lies outside them.  :data:`STEPS` counts the minibatches of each
    path."""
    n = perm.shape[0]
    if graph is not None:
        losses = torch.empty(n, dtype=data.z.dtype, device=data.z.device)
        for b in range(n):
            losses[b].copy_(graph(perm[b], starts[b]))
        STEPS["replayed"] += n
        return losses.mean()
    offsets = torch.arange(tc.rollout_steps + 1, device=perm.device)
    losses = []
    for b in range(n):
        idx, widx = perm[b], starts[b][:, None] + offsets
        if dp is not None:
            idx = idx.chunk(dp.world)[dp.rank]
            if dp.shard_windows:
                widx = widx.chunk(dp.world)[dp.rank]
        losses.append(_step(net, opt, data, idx, widx, tc, rp, use_rollout, dp))
    STEPS["eager"] += n
    return torch.stack(losses).mean()


def epoch_draws(generator: Optional[torch.Generator], N: int, n_batches: int, batch: int,
                tc: TrainConfig, device=None):
    """One epoch's draws: a permutation of the ``N`` rows cut to
    ``(n_batches, batch)`` and the rollout windows' starts ``(n_batches,
    tc.rollout_windows)`` in ``[0, max(N - steps - 1, 1))``."""
    device = device if device is not None else (generator.device if generator is not None
                                                else None)
    perm = torch.randperm(N, generator=generator, device=device)[: n_batches * batch]
    starts = torch.randint(0, max(N - tc.rollout_steps - 1, 1), (n_batches, tc.rollout_windows),
                           generator=generator, device=device)
    return perm.reshape(n_batches, batch), starts


def train_from_draws(net: PINcNet, data: PINcData, draws: Iterable, tc: TrainConfig = TrainConfig(),
                     rp: ReducedParams | None = None, log_every: int = 0, mesh=None,
                     graph: Optional[bool] = None):
    """Train ``net`` in place, one epoch for each ``(perm, starts)`` of
    ``draws`` (see :func:`train_epoch`); returns ``(net, history)``, the
    mean loss of each epoch as floats, read back once at the end.

    ``mesh`` (a ``DeviceMesh`` of the port's ``parallel/mesh.py``) trains
    data-parallel over its first axis: the parameters and each epoch's
    draws are broadcast from its first rank, each minibatch splits over
    the ranks and the gradients are averaged.  The effective batch
    ``min(tc.batch, N)`` must divide over that axis.  ``graph`` (default:
    on CUDA without a mesh) captures one minibatch step as a CUDA graph
    and replays it for every minibatch of every epoch of the call
    (:class:`_CapturedStep`); otherwise the steps run eagerly."""
    N = data.z.shape[0]
    batch = min(tc.batch, N)
    captured = use_graph(graph, data.z.device, mesh)
    dp = None
    if mesh is not None:
        from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh

        axis = mesh.mesh_dim_names[0]
        group, n_dev, rank = pmesh.axis(mesh, axis)
        if batch % n_dev:
            raise ValueError(
                f"effective batch {batch} (min(tc.batch={tc.batch}, N={N})) "
                f"must divide over the {n_dev}-way {axis!r} mesh axis")
        dp = _DataParallel(group, n_dev, rank, tc.rollout_windows % n_dev == 0)
        with torch.no_grad():
            for p, q in zip(net.parameters(), pmesh.replicate(mesh, list(net.parameters()))):
                p.copy_(q)
    if rp is None:
        rp = reduced_params(dtype=data.z.dtype, device=data.z.device)
    n_batches = max(N // batch, 1)
    opt = make_optimizer(tc, net.parameters(), total_steps=tc.epochs * n_batches)
    use_rollout = tc.rollout_weight > 0 and tc.rollout_steps > 0 and N > tc.rollout_steps + 1
    step = _CapturedStep(net, opt, data, tc, rp, use_rollout) if captured else None
    history = []
    try:
        for ep, (perm, starts) in enumerate(draws):
            perm = torch.as_tensor(perm, dtype=torch.long, device=data.z.device)
            starts = torch.as_tensor(starts, dtype=torch.long, device=data.z.device)
            if mesh is not None:
                perm, starts = pmesh.replicate(mesh, (perm, starts))
            history.append(train_epoch(net, opt, data, perm, starts, tc, rp, use_rollout, dp,
                                       step))
            if log_every and (ep + 1) % log_every == 0:
                print(f"[PINc] epoch {ep + 1:4d}/{tc.epochs} | loss ~ {float(history[-1]):.6f}")
    finally:
        if step is not None:
            step.close()
    return net, (torch.stack(history).double().cpu().tolist() if history else [])


def train(generator: Optional[torch.Generator], data: PINcData, tc: TrainConfig = TrainConfig(),
          hidden: Sequence[int] = (64, 64, 64, 64), rp: ReducedParams | None = None,
          log_every: int = 0, mesh=None):
    """Train PINc from scratch; returns ``(net, history)``.

    ``generator`` (on the data's device) draws the initial parameters,
    then every epoch's permutation and window starts.  With
    ``tc.normalize`` the input statistics of ``data.z`` standardise the
    MLP input (else the identity).  ``mesh``: see :func:`train_from_draws`.
    """
    if tc.normalize:
        mu, sigma = input_stats(data.z)
    else:
        mu, sigma = np.zeros(14), np.ones(14)
    net = init_params(generator, hidden, dtype=data.z.dtype, norm_mu=mu, norm_sigma=sigma,
                      position_invariant=tc.position_invariant, device=data.z.device)
    N = data.z.shape[0]
    batch = min(tc.batch, N)
    n_batches = max(N // batch, 1)
    draws = (epoch_draws(generator, N, n_batches, batch, tc, data.z.device)
             for _ in range(tc.epochs))
    return train_from_draws(net, data, draws, tc, rp, log_every, mesh)


# ---------------------------------------------------------------------------
# Rollout and metrics
# ---------------------------------------------------------------------------

def make_step(net: PINcNet, dt):
    """Discrete 9-state step ``step(x9_batch, u4_batch) -> x9_batch``."""

    def step(x9, u4):
        dt_col = torch.full((*x9.shape[:-1], 1), float(dt), dtype=x9.dtype, device=x9.device)
        return net(torch.cat([x9, u4, dt_col], dim=-1))

    return step


@torch.no_grad()
def simulate(net: PINcNet, x0_12, U4_seq, dt):
    """Open-loop rollout; returns ``(T+1, 12)`` through the 9 -> 12
    embedding, with ``x0_12`` itself in row 0."""
    _, traj9 = rollout(make_step(net, dt), state12_to_9(x0_12), U4_seq)
    return torch.cat([x0_12[None], state9_to_12(traj9)], dim=0)


@torch.no_grad()
def endpoint_rmse(net: PINcNet, X12, U4, dt, H: int, psi_error: str = "raw"):
    """Endpoint H-step RMSE in the 12-D projection over all ``N - H``
    starts: the starts go 12 -> 9 once, step H times together, and the
    endpoints go back to 12-D (phi, theta, p, q zero) to be scored.

    ``psi_error="raw"`` scores psi as recorded (unwrapped), as the
    reference does; ``"ssa"`` scores its error by the smallest signed
    angle.  Anything else raises ``ValueError``; ``H >= N`` gives NaN."""
    if psi_error not in ("raw", "ssa"):
        raise ValueError(f"psi_error must be 'raw' or 'ssa', got {psi_error!r}")
    n_start = X12.shape[0] - H
    if n_start <= 0:
        return torch.tensor(float("nan"), dtype=X12.dtype, device=X12.device)
    step = make_step(net, dt)
    x9 = state12_to_9(X12[:n_start])
    for t in range(H):
        x9 = step(x9, U4[t:t + n_start])
    pred = state9_to_12(x9)
    if psi_error == "ssa":
        err = pred - X12[H:]
        err = torch.cat([err[..., :5], ssa(err[..., 5:6]), err[..., 6:]], dim=-1)
        return torch.sqrt(torch.mean(err * err))
    return rmse(X12[H:], pred)


def load_torch_checkpoint(path, hidden: Sequence[int] = (64, 64, 64, 64), dtype=torch.float32,
                          allow_full_unpickle: bool = False, device=None) -> PINcNet:
    """A reference PINc ``state_dict`` checkpoint (``.pt``) as a
    :class:`PINcNet` with identity input normalisation and torch's
    LayerNorm epsilon 1e-5.

    The file is read with ``torch.load(weights_only=True)``; one that is
    not a plain tensor state dict (a whole pickled module) is refused
    with ``ValueError`` unless ``allow_full_unpickle``, since full
    unpickling runs code from the file.  Keys or shapes that differ from
    ``PINcNet(hidden)``'s raise ``ValueError``.
    """
    import pickle

    from bluerov2_dynamics_tpu_torch.device import resolve_device

    try:
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not allow_full_unpickle:
            raise ValueError(
                f"{path} is not a weights-only checkpoint; pass "
                "allow_full_unpickle=True to fully unpickle it (runs "
                "arbitrary code from the file — only for trusted files)") from None
        sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    net = load_checked(PINcNet(hidden, ln_eps=1e-5), sd, f"checkpoint {path}")
    return net.to(device=resolve_device(device), dtype=dtype)

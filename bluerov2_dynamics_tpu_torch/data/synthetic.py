"""Synthetic dataset generation: the simulation dataset and the pseudo tank
recording.

Counterpart of ``bluerov2_dynamics_tpu/data/synthetic.py``.  AR(1)-smoothed
random thruster commands drive the Fossen model (explicit Euler by
default), and per-channel Gaussian sensor noise is added to the recorded
states.

**Random streams.**  The JAX generator draws from ``jax.random``'s
threefry streams; this one draws the same distributions from PyTorch's
CPU generator and is not a bit-exact twin of threefry.  A twin would need
threefry2x32 and ``jax.random.normal``'s inverse-erf path in float32 as a
module of its own.  So the blessed tables of ``RESULTS.md``, which were
measured on the JAX streams, are not reproduced bit for bit by the port:
the port's datasets are other draws of the same processes.

Each generator is split in two:

* ``*_draws(seed, ...)`` makes every random array up front, on the host
  CPU (so one seed gives the same data on the CPU and on the card).  Each
  purpose draws from its own ``torch.Generator``, seeded from ``(seed,
  tag)`` through ``numpy.random.SeedSequence``; this is the role of the
  JAX generator's key split, so the coefficient factors do not depend on
  the recording's length.  Optional draws (the thruster gain jitter) come
  from the stream ``(seed, 99)``, the twin of the JAX generator's
  ``fold_in(key, 99)``: turning an option on never shifts the default
  draws.
* ``*_from_draws(draws, ...)`` does everything else, deterministically.
  The tests feed it the JAX generator's own draws (replaying its key
  splits) and hold the result against the JAX dataset.

**The step loop.**  On the CPU it is a Python loop over the steps (the
plain version).  On a CUDA device a fixed chunk of :data:`GRAPH_CHUNK`
steps of the closed-loop body (commands, the depth and attitude hold, the
thruster step) is captured once as a ``torch.cuda.CUDAGraph`` and
replayed over the recording (``ops/scan.py``, the step loop the filters
share); the body has no host synchronisation.  A capture that fails
raises: there is no quiet return to the eager loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models.fossen import make_thruster_step
from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ThrusterConfig,
    fossen_params,
    lag_params,
    thruster_config,
)
from bluerov2_dynamics_tpu_torch.ops.scan import scan

GRAPH_CHUNK = 256   # steps captured in one CUDA graph and replayed

# stream tags of the draws; GAIN_TAG is the optional draws' (seed, 99)
_TANK_TAGS = {"factors": 1, "normals": 2, "noise": 3, "x0": 4}
_SIM_TAGS = {"normals": 11, "noise": 12}
GAIN_TAG = 99


class SimDataset(NamedTuple):
    X: torch.Tensor        # (N, 12) noisy "measured" states
    X_true: torch.Tensor   # (N, 12) noiseless states
    U: torch.Tensor        # (N, 8) applied inputs
    dt: float


def stream(seed: int, tag: int) -> torch.Generator:
    """The CPU generator of the draws tagged ``tag`` for ``seed``."""
    words = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 32) | int(words[1]))


def _uniform(gen, n, jitter, dtype):
    return (1.0 - jitter) + (2.0 * jitter) * torch.rand(n, generator=gen, dtype=dtype)


def _scan(f: Callable, carry, xs, graph: bool):
    """``ys`` of ``f(carry, x_t) -> (carry, y_t)`` over the rows of ``xs``:
    CUDA graphs of :data:`GRAPH_CHUNK` steps for CUDA inputs when
    ``graph``, else the eager loop (:func:`~bluerov2_dynamics_tpu_torch.ops.scan.scan`)."""
    return scan(f, carry, xs, graph=None if graph else False, chunk=GRAPH_CHUNK)


# ---------------------------------------------------------------------------
# Commands and sensor noise
# ---------------------------------------------------------------------------

def ar1_commands_from_draws(normals, alpha: float = 0.98, noise: float = 0.02,
                            clip: float = 1.0, graph: bool = True):
    """``u_{k+1} = clip(alpha u_k + noise * normals[k])`` from ``u_0 = 0``;
    ``normals (n_steps, n_inputs)`` are standard normal draws."""

    def body(carry, x):
        u = torch.clamp(alpha * carry[0] + noise * x[0], -clip, clip)
        return (u,), (u,)

    return _scan(body, (normals.new_zeros(normals.shape[1]),), (normals,), graph)[0]


def ar1_commands(generator: torch.Generator, n_steps: int, n_inputs: int = 8,
                 alpha: float = 0.98, noise: float = 0.02, clip: float = 1.0,
                 dtype=torch.float32, device=None):
    """Smooth random commands from ``generator``'s standard normals
    (``n_steps, n_inputs``), made on the generator's device and moved to
    ``device`` (``None`` means ``cuda``)."""
    normals = torch.randn(n_steps, n_inputs, generator=generator, dtype=dtype,
                          device=generator.device)
    return ar1_commands_from_draws(normals.to(resolve_device(device)), alpha, noise, clip)


def _add_sensor_noise(normals, X_true, pos_noise, ang_noise, vel_noise, angvel_noise):
    """Per-channel-class sensor noise on a ``(T, 12)`` euler12 trajectory:
    one sigma a 3-channel block times the standard normals ``normals``."""
    sigma = torch.tensor([pos_noise] * 3 + [ang_noise] * 3 + [vel_noise] * 3
                         + [angvel_noise] * 3, dtype=X_true.dtype, device=X_true.device)
    return X_true + sigma * normals


# ---------------------------------------------------------------------------
# The simulation dataset (T1)
# ---------------------------------------------------------------------------

def sim_dataset_draws(seed: int, n_steps: int = 240_000, dtype=torch.float32) -> dict:
    """Every random array of :func:`generate_sim_dataset`: the AR(1)
    normals ``(n_steps, 8)`` and the sensor-noise normals ``(n_steps, 12)``."""
    return {
        "normals": torch.randn(n_steps, 8, generator=stream(seed, _SIM_TAGS["normals"]),
                               dtype=dtype),
        "noise": torch.randn(n_steps, 12, generator=stream(seed, _SIM_TAGS["noise"]),
                             dtype=dtype),
    }


def generate_sim_dataset_from_draws(
    draws: dict,
    dt: float = 0.05,
    p: Optional[FossenParams] = None,
    cfg: Optional[ThrusterConfig] = None,
    lag: Optional[LagParams] = None,
    method: str = "euler",
    pos_noise: float = 5e-4,
    ang_noise: float = 1e-3,
    vel_noise: float = 5e-4,
    angvel_noise: float = 1e-3,
    noise_scale: float = 1.0,
    x0=None,
    dtype=torch.float32,
    device=None,
    graph: bool = True,
) -> SimDataset:
    """The simulation-workload dataset from its draws (states AFTER each
    step, as the reference records them).  ``noise_scale`` multiplies every
    sensor sigma and leaves ``X_true`` and ``U`` unchanged."""
    device = resolve_device(device)
    p = p.to(device) if p is not None else fossen_params(dtype=dtype, device=device)
    cfg = cfg.to(device) if cfg is not None else thruster_config(dtype=dtype, device=device)
    lag = lag.to(device) if lag is not None else lag_params(dt, dtype=dtype, device=device)
    normals = draws["normals"].to(device=device, dtype=dtype)
    step = make_thruster_step(p, cfg, lag, dt, method=method)
    x0 = (torch.zeros(12, dtype=dtype, device=device) if x0 is None
          else torch.as_tensor(x0, dtype=dtype, device=device))

    def body(carry, xs):
        x, lag_state, u = carry
        u = torch.clamp(0.98 * u + 0.02 * xs[0], -1.0, 1.0)
        x, lag_state = step((x, lag_state), u)
        return (x, lag_state, u), (x, u)

    carry0 = (x0, torch.zeros((8, 3), dtype=dtype, device=device),
              torch.zeros(8, dtype=dtype, device=device))
    X_true, U = _scan(body, carry0, (normals,), graph)
    X = _add_sensor_noise(draws["noise"].to(device=device, dtype=dtype), X_true,
                          noise_scale * pos_noise, noise_scale * ang_noise,
                          noise_scale * vel_noise, noise_scale * angvel_noise)
    return SimDataset(X=X, X_true=X_true, U=U, dt=dt)


def generate_sim_dataset(seed: int = 0, n_steps: int = 240_000, dt: float = 0.05,
                         dtype=torch.float32, device=None, graph: bool = True,
                         **kwargs) -> SimDataset:
    """:func:`generate_sim_dataset_from_draws` on :func:`sim_dataset_draws`
    of ``seed``; ``kwargs`` as the former takes them."""
    return generate_sim_dataset_from_draws(sim_dataset_draws(seed, n_steps, dtype), dt=dt,
                                           dtype=dtype, device=device, graph=graph, **kwargs)


# ---------------------------------------------------------------------------
# The pseudo tank recording (T2)
# ---------------------------------------------------------------------------

def perturbed_fossen_params(factors: Sequence[float], dtype=torch.float32,
                            device=None) -> FossenParams:
    """Table A1 coefficients, each scaled by its factor of ``factors`` (23:
    mass, volume, the three inertias, six added masses, six linear and six
    quadratic damping coefficients).  The generator integrates them, so
    the nominal model the apps evaluate is not the generator."""
    d = [float(v) for v in np.asarray(factors, np.float64)]
    return fossen_params(
        m=13.5 * d[0],
        volume=0.0134 * d[1],
        inertia=(0.26 * d[2], 0.23 * d[3], 0.37 * d[4]),
        added=tuple(a * s for a, s in
                    zip((-6.36, -7.12, -18.68, -0.189, -0.135, -0.222), d[5:11])),
        damping_lin=tuple(a * s for a, s in
                          zip((-13.7, -0.0, -33.0, -0.0, -0.8, -0.0), d[11:17])),
        damping_quad=tuple(a * s for a, s in
                           zip((-141.0, -217.0, -190.0, -1.19, -0.47, -1.5), d[17:23])),
        dtype=dtype,
        device=device,
    )


def recording_coefficient_draws(seed: int, jitter: float = 0.10) -> np.ndarray:
    """The 23 coefficient factors :func:`generate_tank_recording` perturbs
    its generator with for ``seed`` and ``jitter`` (float64): the ground
    truth of a coefficient fit."""
    return _uniform(stream(seed, _TANK_TAGS["factors"]), 23, jitter, torch.float64).numpy()


def tank_recording_draws(seed: int, n_steps: int = 45_823, jitter: float = 0.10,
                         thruster_gain_jitter: float = 0.0, dtype=torch.float32) -> dict:
    """Every random array of :func:`generate_tank_recording`: the 23
    coefficient factors (float64), the initial-state normals ``(12,)``, the
    AR(1) normals ``(n_steps, 8)``, the sensor-noise normals ``(n_steps,
    12)``, and, with a gain jitter, the 8 thruster gains from the optional
    stream ``(seed, 99)``."""
    draws = {
        "factors": _uniform(stream(seed, _TANK_TAGS["factors"]), 23, jitter, torch.float64),
        "x0": torch.randn(12, generator=stream(seed, _TANK_TAGS["x0"]), dtype=dtype),
        "normals": torch.randn(n_steps, 8, generator=stream(seed, _TANK_TAGS["normals"]),
                               dtype=dtype),
        "noise": torch.randn(n_steps, 12, generator=stream(seed, _TANK_TAGS["noise"]),
                             dtype=dtype),
    }
    if thruster_gain_jitter > 0.0:
        draws["gains"] = _uniform(stream(seed, GAIN_TAG), 8, thruster_gain_jitter, dtype)
    return draws


def generate_tank_recording_from_draws(
    draws: dict,
    dt: float = 0.02,
    yaw_drive: float = 0.05,
    pos_noise: float = 1e-3,
    ang_noise: float = 2e-3,
    vel_noise: float = 1e-3,
    angvel_noise: float = 2e-3,
    noise_scale: float = 1.0,
    current=(0.0, 0.0, 0.0),
    method: str = "euler",
    dtype=torch.float32,
    device=None,
    graph: bool = True,
) -> SimDataset:
    """The pseudo tank recording from its draws: a validation dataset the
    evaluated models cannot trivially reproduce.

    * the generator integrates the perturbed coefficients of
      ``draws["factors"]``, so the nominal model is not the generator;
    * AR(1) commands carry a slowly modulated differential yaw bias on
      T1-T4, so psi winds far beyond +-pi (states keep unwrapped angles);
    * a proportional depth hold and a roll/pitch hold act on T5-T8;
    * sensor noise on every channel (``noise_scale`` multiplies the four
      sigmas and leaves ``X_true`` and ``U`` unchanged);
    * optional mismatch the nominal model cannot express: per-thruster
      gains (``draws["gains"]``) and an ambient ``current`` in NED.
    """
    device = resolve_device(device)
    normals = draws["normals"].to(device=device, dtype=dtype)
    n_steps = normals.shape[0]
    p_gen = perturbed_fossen_params(draws["factors"], dtype=dtype, device=device)
    if any(float(c) != 0.0 for c in current):
        p_gen = p_gen._replace(current=torch.as_tensor(current, dtype=dtype, device=device))
    cfg = thruster_config(dtype=dtype, device=device)
    if draws.get("gains") is not None:
        gains = draws["gains"].to(device=device, dtype=dtype)
        cfg = cfg._replace(wrench_map=cfg.wrench_map * gains[:, None])
    lag = lag_params(dt, dtype=dtype, device=device)

    # Pilot-like command model: AR(1) exploration noise, a differential yaw
    # bias on the vectored thrusters, a depth hold and a roll/pitch hold on
    # the vertical ones (without an attitude loop the model's zero linear
    # roll damping lets the AR(1) noise pump the roll pendulum).
    zero4 = torch.zeros(4, dtype=dtype, device=device)
    yaw_pattern = torch.cat([torch.sign(cfg.wrench_map[:4, 5]), zero4])
    vert_pattern = torch.cat([zero4, torch.ones(4, dtype=dtype, device=device)])
    roll_pattern = torch.cat([zero4, torch.sign(cfg.wrench_map[4:, 3])])
    pitch_pattern = torch.cat([zero4, torch.sign(cfg.wrench_map[4:, 4])])
    t = torch.arange(n_steps, dtype=dtype, device=device) * dt
    bias = yaw_drive * (0.02 + 0.98 * torch.sin(2.0 * math.pi * t / 240.0))

    step = make_thruster_step(p_gen, cfg, lag, dt, method=method)
    x0 = 0.05 * draws["x0"].to(device=device, dtype=dtype)

    def body(carry, xs):
        x, lag_state, u_ar = carry
        n_t, b_t = xs
        u_ar = torch.clamp(0.98 * u_ar + 0.02 * n_t, -1.0, 1.0)
        depth_cmd = torch.clamp(0.25 * x[2] + 0.4 * x[8], -0.6, 0.6)
        roll_cmd = torch.clamp(-1.0 * x[3] - 0.4 * x[9], -0.4, 0.4)
        pitch_cmd = torch.clamp(-1.0 * x[4] - 0.4 * x[10], -0.4, 0.4)
        u = torch.clamp(
            u_ar
            + b_t * yaw_pattern
            + depth_cmd * vert_pattern
            + roll_cmd * roll_pattern
            + pitch_cmd * pitch_pattern,
            -1.0,
            1.0,
        )
        x, lag_state = step((x, lag_state), u)
        return (x, lag_state, u_ar), (x, u)

    carry0 = (x0, torch.zeros((8, 3), dtype=dtype, device=device),
              torch.zeros(8, dtype=dtype, device=device))
    X_true, U = _scan(body, carry0, (normals, bias), graph)
    X = _add_sensor_noise(draws["noise"].to(device=device, dtype=dtype), X_true,
                          noise_scale * pos_noise, noise_scale * ang_noise,
                          noise_scale * vel_noise, noise_scale * angvel_noise)
    return SimDataset(X=X, X_true=X_true, U=U, dt=dt)


def generate_tank_recording(seed: int = 0, n_steps: int = 45_823, dt: float = 0.02,
                            jitter: float = 0.10, thruster_gain_jitter: float = 0.0,
                            dtype=torch.float32, device=None, graph: bool = True,
                            **kwargs) -> SimDataset:
    """:func:`generate_tank_recording_from_draws` on
    :func:`tank_recording_draws` of ``seed``; ``kwargs`` as the former
    takes them."""
    draws = tank_recording_draws(seed, n_steps, jitter, thruster_gain_jitter, dtype)
    return generate_tank_recording_from_draws(draws, dt=dt, dtype=dtype, device=device,
                                              graph=graph, **kwargs)

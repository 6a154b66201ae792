"""Physics demos: the reference's executable consistency checks (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/apps/demo.py``: an explicit Euler
loop printing the pose every step, and an "ODE" integration, here the
RK4 rollout, optionally with a 3-segment tether (40 RK4 substeps a step)
or cross-checked against scipy's BDF on the host (``--bdf``), whose RHS
runs on the demo's device as the JAX demo's runs on its default device.
Both should give consistent results.

Usage::

    python -m bluerov2_dynamics_tpu_torch.apps.demo euler
    python -m bluerov2_dynamics_tpu_torch.apps.demo ode [--tether] [--bdf]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models import fossen, tether
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config

U_DEMO = (0.1, 0.1, 0.1, 0.0, 0.5, 0.5, 0.5, 0.5)


def _print_pose(t, x):
    print(f"Time={t:.2f}, pos=({x[0]:.2f}, {x[1]:.2f}, {x[2]:.2f}, "
          f"{x[3]:.2f}, {x[4]:.2f}, {x[5]:.2f})")


def _setup(dt, t_end, dtype, device):
    device = resolve_device(device)
    p = fossen_params(dtype=dtype, device=device)
    cfg = thruster_config(dtype=dtype, device=device)
    lag = lag_params(dt, dtype=dtype, device=device)
    n = int(t_end / dt)
    x0 = torch.zeros(12, dtype=dtype, device=device)
    x0[2] = 5.0
    U = torch.as_tensor(U_DEMO, dtype=dtype, device=device).expand(n, 8)
    return device, p, cfg, lag, n, x0, U


def run_euler(dt=0.01, t_end=5.0, print_every=1, dtype=torch.float32, device=None):
    """Euler rollout from rest at 5 m depth under the demo commands;
    returns the ``(n+1, 12)`` trajectory as a host array."""
    _, p, cfg, lag, n, x0, U = _setup(dt, t_end, dtype, device)
    print(f"Starting Euler integration for t=[0...{t_end}] at dt={dt}")
    with torch.no_grad():
        traj = fossen.simulate_thruster(p, cfg, lag, x0, U, dt, method="euler").cpu().numpy()
    for k in range(1, n + 1, print_every):
        _print_pose(k * dt, traj[k])
    return traj


def run_ode(dt=0.01, t_end=5.0, use_tether=False, bdf_check=False, print_every=100,
            dtype=torch.float32, device=None):
    """RK4 rollout (with a 3-segment, 20 m tether when ``use_tether``);
    ``bdf_check`` also integrates the lag-free model with scipy's BDF on
    the host and prints its endpoint.  Returns the trajectory as a host
    array."""
    device, p, cfg, lag, n, x0, U = _setup(dt, t_end, dtype, device)
    print(f"Starting substepped-RK4 integration for t=[0...{t_end}] at dt={dt}"
          + (" with tether" if use_tether else ""))
    with torch.no_grad():
        if use_tether:
            tcfg = tether.TetherConfig(n_segments=3, length=20.0)
            anchor = torch.zeros(3, dtype=dtype, device=device)
            x_teth = tether.init_nodes_line(tcfg, np.zeros(3), np.array([0.0, 0.0, 5.0]),
                                            dtype=dtype, device=device)
            traj = tether.simulate_with_tether(p, cfg, lag, tcfg, anchor,
                                               torch.cat([x0, x_teth]), U, dt)
        else:
            lag0 = torch.zeros((8, 3), dtype=dtype, device=device)
            traj = fossen.simulate_thruster(p, cfg, lag, x0, U, dt, method="rk4",
                                            lag_state0=lag0)
    traj = traj.cpu().numpy()
    for k in range(0, n + 1, print_every):
        _print_pose(k * dt, traj[k])

    if bdf_check and not use_tether:
        from scipy.integrate import solve_ivp

        from bluerov2_dynamics_tpu_torch.models.thrusters import thruster_wrench_nolag

        tau = thruster_wrench_nolag(cfg, torch.as_tensor(U_DEMO, dtype=dtype, device=device))

        def rhs(t, x):
            with torch.no_grad():
                xt = torch.as_tensor(x, dtype=dtype, device=device)
                return fossen.wrench_rhs_euler(p, xt, tau).cpu().numpy()

        sol = solve_ivp(rhs, (0.0, t_end), np.zeros(12) + x0.cpu().numpy(), method="BDF",
                        rtol=3e-6, atol=1e-7)
        print(f"[i] BDF endpoint pos: {sol.y[0:3, -1]}")
    return traj


def main(argv=None, device=None):
    """The demo CLI; ``device=None`` means ``cuda``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["euler", "ode"])
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--t-end", type=float, default=5.0)
    ap.add_argument("--tether", action="store_true")
    ap.add_argument("--bdf", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "euler":
        return run_euler(args.dt, args.t_end, device=device)
    return run_ode(args.dt, args.t_end, args.tether, args.bdf, device=device)


if __name__ == "__main__":
    main()

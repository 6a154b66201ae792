"""The port's lumped-mass tether (``models/tether.py``) and physics demo
(``apps/demo.py``) against the JAX package's, on the CPU, at small size
(3-5 segments, a few steps).

Tolerances: the tether dynamics at atol 1e-9 in float64 (the same
operations; the JAX norm is a square root of a sum of squares too); the
coupled rollout's ROV state at atol 1e-9 in float64 over 20 steps of 40
RK4 substeps, and against scipy's BDF at atol 2e-4 (the JAX test's bound).
The demo's trajectories at atol 1e-6 (Euler, RK4; the JAX demo builds its
coefficients in float32 under the tests' x64 mode, the port in float64);
the tethered demo on the ROV's 12 states at atol 1e-6, since the tether
nodes' stiff axial modes reach 600 m/s by 0.3 s, where float32
coefficients move them by ~1e-3 relative.
"""

import io
import contextlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.apps import demo as jdemo
from bluerov2_dynamics_tpu.models import tether as jtether
from bluerov2_dynamics_tpu.models.params import fossen_params as jfossen_params
from bluerov2_dynamics_tpu.models.params import lag_params as jlag_params
from bluerov2_dynamics_tpu.models.params import thruster_config as jthruster_config
from bluerov2_dynamics_tpu_torch.apps import demo
from bluerov2_dynamics_tpu_torch.models import tether
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config

CFG = tether.TetherConfig(n_segments=5, length=10.0)
JCFG = jtether.TetherConfig(n_segments=5, length=10.0)
U_DEMO = np.array([0.1, 0.1, 0.1, 0.0, 0.5, 0.5, 0.5, 0.5])
f64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def test_config_matches_jax():
    for n in (1, 3, 5, 10):
        a, b = tether.TetherConfig(n_segments=n), jtether.TetherConfig(n_segments=n)
        assert (a.n_states, a.l0, a.node_mass, a.cross_area) == (
            b.n_states, b.l0, b.node_mass, b.cross_area)
    np.testing.assert_array_equal(
        tether.init_nodes_line(CFG, np.zeros(3), [6.0, 3.0, 8.0], **f64).numpy(),
        np.asarray(jtether.init_nodes_line(JCFG, np.zeros(3), np.array([6.0, 3.0, 8.0]),
                                           dtype=jnp.float64)))
    assert tether.init_nodes_line(tether.TetherConfig(n_segments=1), np.zeros(3), np.ones(3),
                                  **f64).shape == (0,)


@pytest.mark.parametrize("batch", [None, 5])
def test_tether_dynamics_matches_jax(batch, rng):
    shape = () if batch is None else (batch,)
    rov_pos = np.array([6.0, 3.0, 8.0]) + rng.normal(size=(*shape, 3)) * 0.5
    x = np.asarray(jtether.init_nodes_line(JCFG, np.zeros(3), np.array([6.0, 3.0, 8.0]),
                                           dtype=jnp.float64))
    x = x + rng.normal(size=(*shape, x.shape[0])) * 0.3   # varied stretch and slack
    rov_vel = rng.normal(size=(*shape, 3)) * 0.5
    current = np.array([0.2, -0.1, 0.0])
    want_dx, want_F = jtether.tether_dynamics(JCFG, jnp.asarray(x), jnp.zeros(3),
                                              jnp.asarray(rov_pos), jnp.asarray(rov_vel),
                                              jnp.asarray(current))
    got_dx, got_F = tether.tether_dynamics(CFG, _t(x), torch.zeros(3, dtype=torch.float64),
                                           _t(rov_pos), _t(rov_vel), _t(current))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-9)
    np.testing.assert_allclose(got_F.numpy(), np.asarray(want_F), atol=1e-9)


def test_slack_and_taut_cable():
    cfg = tether.TetherConfig(n_segments=4, length=40.0)   # l0 = 10: slack at 20 m
    z = torch.zeros(3, dtype=torch.float64)
    x = tether.init_nodes_line(cfg, np.zeros(3), [0.0, 0.0, 20.0], **f64)
    _, F = tether.tether_dynamics(cfg, x, z, _t([0.0, 0.0, 20.0]), z, z)
    assert torch.all(F == 0.0)
    cfg = tether.TetherConfig(n_segments=4, length=10.0)   # stretched by 2 m
    x = tether.init_nodes_line(cfg, np.zeros(3), [0.0, 0.0, 12.0], **f64)
    _, F = tether.tether_dynamics(cfg, x, z, _t([0.0, 0.0, 12.0]), z, z)
    assert F[2] > 0 and torch.all(F[:2].abs() < 1e-12)


@pytest.fixture(scope="module")
def coupled():
    """20 steps of the thruster-driven ROV on a 3-segment, 20 m tether."""
    cfg = tether.TetherConfig(n_segments=3, length=20.0)
    x0 = np.zeros(12)
    x0[2] = 5.0
    x_ext0 = np.concatenate(
        [x0, tether.init_nodes_line(cfg, np.zeros(3), x0[:3], **f64).numpy()])
    U = np.broadcast_to(U_DEMO, (20, 8))
    return cfg, x_ext0, U


@pytest.mark.parametrize("use_lag", [True, False])
def test_coupled_rollout_matches_jax(use_lag, coupled):
    cfg, x_ext0, U = coupled
    jcfg = jtether.TetherConfig(n_segments=3, length=20.0)
    want = jtether.simulate_with_tether(
        jfossen_params(dtype=jnp.float64), jthruster_config(dtype=jnp.float64),
        jlag_params(0.01, dtype=jnp.float64), jcfg, jnp.zeros(3), jnp.asarray(x_ext0),
        jnp.asarray(U), 0.01, use_lag=use_lag)
    got = tether.simulate_with_tether(
        fossen_params(**f64), thruster_config(**f64), lag_params(0.01, **f64), cfg,
        torch.zeros(3, dtype=torch.float64), _t(x_ext0), _t(U), 0.01, use_lag=use_lag)
    assert got.shape == (21, 24)
    np.testing.assert_allclose(got[:, :12].numpy(), np.asarray(want)[:, :12], atol=1e-9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_coupled_rollout_matches_bdf(coupled):
    """The substepped RK4 against scipy's implicit BDF on the same RHS (the
    reference's own consistency check)."""
    from scipy.integrate import solve_ivp

    from bluerov2_dynamics_tpu_torch.models.thrusters import thruster_wrench_nolag

    cfg, x_ext0, U = coupled
    p, thr = fossen_params(**f64), thruster_config(**f64)
    traj = tether.simulate_with_tether(p, thr, lag_params(0.01, **f64), cfg,
                                       torch.zeros(3, dtype=torch.float64), _t(x_ext0), _t(U),
                                       0.01, use_lag=False)
    tau = thruster_wrench_nolag(thr, _t(U_DEMO))
    anchor = torch.zeros(3, dtype=torch.float64)
    sol = solve_ivp(lambda t, x: tether.coupled_rhs(p, cfg, _t(x), tau, anchor).numpy(),
                    (0.0, 0.2), x_ext0, method="BDF", rtol=1e-7, atol=1e-9)
    assert sol.success
    np.testing.assert_allclose(traj[-1, :12].numpy(), sol.y[:12, -1], atol=2e-4)


# --- the demo -------------------------------------------------------------------

def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def test_demo_euler_matches_jax():
    want, jtext = _quiet(jdemo.run_euler, dt=0.01, t_end=0.5, print_every=10)
    got, text = _quiet(demo.run_euler, dt=0.01, t_end=0.5, print_every=10, **f64)
    assert got.shape == (51, 12) and "Time=0.41" in text
    assert text.count("Time=") == jtext.count("Time=") == 5
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_demo_ode_and_bdf_match_jax():
    want, jtext = _quiet(jdemo.run_ode, dt=0.01, t_end=0.5, bdf_check=True, print_every=10)
    got, text = _quiet(demo.run_ode, dt=0.01, t_end=0.5, bdf_check=True, print_every=10, **f64)
    assert got.shape == (51, 12)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    bdf = [np.array(re.search(r"BDF endpoint pos: \[(.*)\]", t).group(1).split(), float)
           for t in (text, jtext)]
    np.testing.assert_allclose(bdf[0], bdf[1], atol=1e-6)


def test_demo_ode_with_tether_matches_jax():
    want, _ = _quiet(jdemo.run_ode, dt=0.01, t_end=0.3, use_tether=True, print_every=10)
    got, text = _quiet(demo.run_ode, dt=0.01, t_end=0.3, use_tether=True, print_every=10, **f64)
    assert got.shape == (31, 24) and np.all(np.isfinite(got)) and "with tether" in text
    np.testing.assert_allclose(got[:, :12], np.asarray(want)[:, :12], atol=1e-6)


def test_demo_main_parses_its_modes():
    got, text = _quiet(demo.main, ["euler", "--t-end", "0.05"], device="cpu")
    assert got.shape == (6, 12) and got.dtype == np.float32 and text.count("Time=") == 5
    with pytest.raises(SystemExit):
        _quiet(demo.main, ["rk45"], device="cpu")

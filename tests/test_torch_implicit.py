"""The port's implicit fixed-step integrators (``ops/implicit.py``) against
the JAX package's, on the CPU, in float64.

Tolerances: steps of the same Newton iteration on the same RHS at rtol
1e-10 (a dense solve in another library); the trapezoidal rule's order
between 1.8 and 2.2 and the stiff backward-Euler decay as the JAX tests
hold them; the tethered ROV at dt = 0.01 with no substeps against the JAX
step at atol 1e-9 on the ROV state and against the substepped RK4 rollout
at atol 3e-3 (the JAX test's bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import tether as jtether
from bluerov2_dynamics_tpu.models.params import fossen_params as jfossen_params
from bluerov2_dynamics_tpu.models.params import thruster_config as jthruster_config
from bluerov2_dynamics_tpu.models.thrusters import thruster_wrench_nolag as jwrench_nolag
from bluerov2_dynamics_tpu.ops import implicit as jimplicit
from bluerov2_dynamics_tpu_torch.models import tether
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.models.thrusters import thruster_wrench_nolag
from bluerov2_dynamics_tpu_torch.ops import implicit
from bluerov2_dynamics_tpu_torch.ops.integrators import rk4_step

f64 = dict(dtype=torch.float64, device="cpu")
U_DEMO = [0.1, 0.1, 0.1, 0.0, 0.5, 0.5, 0.5, 0.5]


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.mark.parametrize("method", ["trapezoidal", "backward_euler"])
def test_nonlinear_steps_match_jax(method):
    u = np.array([0.3, -0.2])
    jstep = jimplicit.make_implicit_step(lambda x, v: jnp.sin(x) - 0.5 * x * x + v, 0.05,
                                         method, newton_iters=5)
    step = implicit.make_implicit_step(lambda x, v: torch.sin(x) - 0.5 * x * x + v, 0.05,
                                       method, newton_iters=5)
    jx, x = jnp.asarray([0.5, -1.0]), _t([0.5, -1.0])
    for _ in range(10):
        jx, x = jstep(jx, jnp.asarray(u)), step(x, _t(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10)


def test_trapezoidal_convergence_order():
    errs = []
    for dt in (0.1, 0.05):
        step = implicit.make_implicit_step(lambda x, u: -x, dt, "trapezoidal", newton_iters=10)
        x = _t([1.0])
        for _ in range(int(round(1.0 / dt))):
            x = step(x, None)
        errs.append(abs(float(x[0]) - np.exp(-1.0)))
    assert 1.8 < np.log2(errs[0] / errs[1]) < 2.2


def test_backward_euler_l_stability_stiff():
    """lambda dt = -1000: explicit RK4 blows up, backward Euler decays."""
    rhs = lambda x, u: -1e4 * x  # noqa: E731
    assert abs(float(rk4_step(rhs, _t([1.0]), None, 0.1)[0])) > 1.0
    step = implicit.make_implicit_step(rhs, 0.1, "backward_euler", newton_iters=4)
    x = _t([1.0])
    for _ in range(5):
        x = step(x, None)
        assert abs(float(x[0])) < 1.0
    assert abs(float(x[0])) < 1e-10


def test_batched_through_vmap_equals_one_at_a_time():
    step = implicit.make_implicit_step(lambda x, u: torch.sin(x) - 0.5 * x + u, 0.05,
                                       "trapezoidal", newton_iters=6)
    xs = _t(np.random.default_rng(0).normal(size=(4, 3)))
    u = _t([0.1, 0.2, -0.3])
    batched = torch.func.vmap(step, in_dims=(0, None))(xs, u)
    for i in range(4):
        np.testing.assert_allclose(batched[i].numpy(), step(xs[i], u).numpy(), rtol=1e-13)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="unknown method 'bdf'"):
        implicit.make_implicit_step(lambda x, u: x, 0.1, "bdf")


def test_implicit_tether_at_coarse_dt_matches_jax_and_the_substepped_rollout():
    """The coupled ROV + tether at dt = 0.01 with no substeps: explicit RK4
    diverges, backward Euler stays bounded, matches the JAX step and tracks
    the substepped explicit rollout on the ROV state."""
    dt, T = 0.01, 50
    cfg = tether.TetherConfig(n_segments=3, length=20.0)
    jcfg = jtether.TetherConfig(n_segments=3, length=20.0)
    x0 = np.zeros(12)
    x0[2] = 5.0
    x_ext0 = np.concatenate([x0, tether.init_nodes_line(cfg, np.zeros(3), x0[:3], **f64).numpy()])
    p, thr = fossen_params(**f64), thruster_config(**f64)
    tau = thruster_wrench_nolag(thr, _t(U_DEMO))
    anchor = torch.zeros(3, dtype=torch.float64)
    rhs = lambda x, t: tether.coupled_rhs(p, cfg, x, t, anchor)  # noqa: E731

    x = _t(x_ext0)
    for _ in range(50):
        x = rk4_step(rhs, x, tau, dt)
    assert not torch.isfinite(x).all()

    step = implicit.make_implicit_step(rhs, dt, "backward_euler", newton_iters=8)
    jp = jfossen_params(dtype=jnp.float64)
    jtau = jwrench_nolag(jthruster_config(dtype=jnp.float64), jnp.asarray(U_DEMO))
    jstep = jax.jit(jimplicit.make_implicit_step(
        lambda x, t: jtether.coupled_rhs(jp, jcfg, x, t, jnp.zeros(3)), dt, "backward_euler",
        newton_iters=8))
    x, jx = _t(x_ext0), jnp.asarray(x_ext0)
    for _ in range(T):
        x, jx = step(x, tau), jstep(jx, jtau)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x[:12].numpy(), np.asarray(jx)[:12], atol=1e-9)

    traj = tether.simulate_with_tether(p, thr, lag_params(dt, **f64), cfg, anchor, _t(x_ext0),
                                       _t(U_DEMO).expand(T, 8), dt, use_lag=False)
    np.testing.assert_allclose(x[:12].numpy(), traj[-1, :12].numpy(), atol=3e-3)

"""The port's euler12 thruster chain against the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages.  Tolerances:
float64 cases agree to 1e-10 (same formulas, different libm); float32
cases to atol 2e-5, the JAX package's own tolerance for its f32 kernels
(tests/test_pallas_rollout.py).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.models import thrusters as jthr
from bluerov2_dynamics_tpu.ops import integrators as jint
from bluerov2_dynamics_tpu.ops import quaternion as jq
from bluerov2_dynamics_tpu.ops import rotations as jrot
from bluerov2_dynamics_tpu_torch.models import fossen as tfossen
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.models import thrusters as tthr
from bluerov2_dynamics_tpu_torch.ops import integrators as tint
from bluerov2_dynamics_tpu_torch.ops import rotations as trot

F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=0.0, atol=2e-5)


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(np.asarray(a), dtype=getattr(torch, dtype)))


def _models(dt=0.02, current=(0.0, 0.0, 0.0), dtype="float32"):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = (jparams.fossen_params(current=current, dtype=jd),
         jparams.thruster_config(dtype=jd), jparams.lag_params(dt, dtype=jd))
    t = (tparams.fossen_params(current=current, dtype=td, device="cpu"),
         tparams.thruster_config(dtype=td, device="cpu"),
         tparams.lag_params(dt, dtype=td, device="cpu"))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# --- rotations ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["ssa", "rotation_matrix", "rotate_b2n", "rotate_n2b",
                                  "euler_kinematics_matrix", "euler_rates"])
def test_rotations_match_jax(name, rng):
    ang = rng.uniform(-4.0, 4.0, size=(3, 7))
    v = rng.normal(size=(7, 3))
    (jphi, tphi), (jth, tth), (jpsi, tpsi) = (_pair(a, "float64") for a in ang)
    jv, tv = _pair(v, "float64")
    jargs, targs = {
        "ssa": ((jphi,), (tphi,)),
        "rotation_matrix": ((jphi, jth, jpsi), (tphi, tth, tpsi)),
        "rotate_b2n": ((jphi, jth, jpsi, jv), (tphi, tth, tpsi, tv)),
        "rotate_n2b": ((jphi, jth, jpsi, jv), (tphi, tth, tpsi, tv)),
        "euler_kinematics_matrix": ((jphi, jth), (tphi, tth)),
        "euler_rates": ((jphi, jth, jv), (tphi, tth, tv)),
    }[name]
    _close(getattr(trot, name)(*targs), getattr(jrot, name)(*jargs), F64)


@pytest.mark.parametrize("theta", [math.pi / 2, -math.pi / 2])
def test_gimbal_clamp_keeps_its_sign(theta):
    # cos(+-pi/2) is a tiny positive or negative float, not zero: the clamp
    # must replace it by +-1e-7 with the sign of cos, as the reference does
    jphi, tphi = _pair([0.3], "float64")
    jth, tth = _pair([theta], "float64")
    om = [[0.1, -0.2, 0.3]]
    jom, tom = _pair(om, "float64")
    got = trot.euler_rates(tphi, tth, tom)
    want = jrot.euler_rates(jphi, jth, jom)
    assert np.all(np.isfinite(got.numpy()))
    _close(got, want, F64)
    cth = trot._clamped_cos_theta(tth)
    assert abs(cth.item()) == pytest.approx(1e-7)
    assert np.sign(cth.item()) == np.sign(math.cos(theta))
    # in float32, cos(fl(pi/2)) is negative: the clamp follows that sign
    th32 = torch.tensor([math.pi / 2], dtype=torch.float32)
    assert trot._clamped_cos_theta(th32).item() == pytest.approx(-1e-7)
    assert trot._clamped_cos_theta(torch.zeros(1)).item() == 1.0  # untouched


# --- integrators ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_integrator_steps_match_jax(method, rng):
    A = rng.normal(size=(4, 4)) * 0.5
    x = rng.normal(size=(5, 4))
    u = rng.normal(size=(5, 4))
    jA, tA = _pair(A, "float64")
    jx, tx = _pair(x, "float64")
    ju, tu = _pair(u, "float64")
    jstep = {"euler": jint.euler_step, "rk4": jint.rk4_step}[method]
    tstep = {"euler": tint.euler_step, "rk4": tint.rk4_step}[method]
    want = jstep(lambda x, u: jnp.sin(x @ jA) + u, jx, ju, 0.05)
    got = tstep(lambda x, u: torch.sin(x @ tA) + u, tx, tu, 0.05)
    _close(got, want, F64)


def test_rollout_stepper_and_rollout_match_jax(rng):
    x0 = rng.normal(size=(3, 2))
    us = rng.normal(size=(6, 3, 2))
    jx, tx = _pair(x0, "float64")
    jus, tus = _pair(us, "float64")
    rhs_j = lambda x, u: -x + jnp.cos(u)  # noqa: E731
    rhs_t = lambda x, u: -x + torch.cos(u)  # noqa: E731
    jstep = jint.rollout_stepper(rhs_j, 0.1, "rk4", substeps=3)
    tstep = tint.rollout_stepper(rhs_t, 0.1, "rk4", substeps=3)
    jfin, jtraj = jint.rollout(jstep, jx, jus, include_initial=True)
    tfin, ttraj = tint.rollout(tstep, tx, tus, include_initial=True)
    assert ttraj.shape == (7, 3, 2)
    _close(tfin, jfin, F64)
    _close(ttraj, jtraj, F64)
    with pytest.raises(ValueError):
        tint.rollout_stepper(rhs_t, 0.1, "rk2")


# --- thrusters -----------------------------------------------------------------

def test_static_thrust_and_wrench_match_jax(rng):
    (_, jcfg, _), (_, tcfg, _) = _models(dtype="float64")
    V = rng.uniform(-1.0, 1.0, size=(9, 8))
    jV, tV = _pair(V, "float64")
    _close(tthr.static_thrust(tcfg, tV), jthr.static_thrust(jcfg, jV), F64)
    _close(tthr.thruster_wrench_nolag(tcfg, tV), jthr.thruster_wrench_nolag(jcfg, jV), F64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lag_step_and_thruster_wrench_match_jax(dtype, rng):
    (_, jcfg, jlag), (_, tcfg, tlag) = _models(dtype=dtype)
    tol = F64 if dtype == "float64" else F32
    L = rng.normal(size=(4, 8, 3))
    u = rng.uniform(-1.0, 1.0, size=(4, 8))
    jL, tL = _pair(L, dtype)
    ju, tu = _pair(u, dtype)
    jn, jF = jthr.lag_step(jlag, jL, jthr.static_thrust(jcfg, ju))
    tn, tF = tthr.lag_step(tlag, tL, tthr.static_thrust(tcfg, tu))
    _close(tn, jn, tol)
    _close(tF, jF, tol)
    jn, jtau = jthr.thruster_wrench(jcfg, jlag, jL, ju)
    tn, ttau = tthr.thruster_wrench(tcfg, tlag, tL, tu)
    _close(ttau, jtau, tol)
    assert tthr.init_lag_state((2,)).shape == (2, 8, 3)


@pytest.mark.parametrize("use_lag", [True, False])
def test_effective_wrench_history_matches_jax(use_lag, rng):
    (_, jcfg, jlag), (_, tcfg, tlag) = _models()
    U = np.clip(rng.normal(size=(30, 8)) * 0.5, -1, 1)
    jU, tU = _pair(U, "float32")
    want = jthr.effective_wrench_history(jcfg, jlag, jU, use_lag=use_lag)
    got = tthr.effective_wrench_history(tcfg, tlag, tU, use_lag=use_lag)
    # forces reach ~50 N: relative f32 agreement
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_tf_to_ss_matches_jax():
    num, den = [6136.0, 108700.0], [1.0, 89.0, 9258.0, 108700.0]
    for a, b in zip(tthr.tf_to_ss(num, den), jthr.tf_to_ss(num, den)):
        np.testing.assert_array_equal(a, b)


# --- fossen --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wrench_rhs_euler_with_current_matches_jax(dtype, rng):
    (jp, _, _), (tp, _, _) = _models(current=(0.3, -0.2, 0.1), dtype=dtype)
    x = rng.normal(size=(6, 12)) * 0.4
    tau = rng.normal(size=(6, 6)) * 5.0
    jx, tx = _pair(x, dtype)
    jt, tt = _pair(tau, dtype)
    tol = F64 if dtype == "float64" else dict(rtol=1e-5, atol=2e-5)
    _close(tfossen.wrench_rhs_euler(tp, tx, tt), jfossen.wrench_rhs_euler(jp, jx, jt), tol)


@pytest.mark.parametrize("use_lag", [True, False])
def test_thruster_dynamics_matches_jax(use_lag, rng):
    jm, tm = _models(current=(0.2, 0.1, 0.0))
    x = rng.normal(size=(5, 12)) * 0.4
    L = rng.normal(size=(5, 8, 3))
    u = rng.uniform(-1.0, 1.0, size=(5, 8))
    (jx, tx), (jL, tL), (ju, tu) = (_pair(a, "float32") for a in (x, L, u))
    jL1, want = jfossen.thruster_dynamics(*jm, jL, jx, ju, use_lag)
    tL1, got = tfossen.thruster_dynamics(*tm, tL, tx, tu, use_lag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tL1.numpy(), np.asarray(jL1), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("use_lag", [True, False])
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_make_thruster_step_matches_jax(method, use_lag, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag) = _models()
    x = rng.normal(size=(8, 12)) * 0.3
    L = rng.normal(size=(8, 8, 3))
    u = np.clip(rng.normal(size=(8, 8)) * 0.5, -1, 1)
    jx, tx = _pair(x, "float32")
    jL, tL = _pair(L, "float32")
    ju, tu = _pair(u, "float32")
    jstep = jfossen.make_thruster_step(jp, jcfg, jlag, 0.02, method, use_lag)
    tstep = tfossen.make_thruster_step(tp, tcfg, tlag, 0.02, method, use_lag)
    (jx1, jL1), (tx1, tL1) = jstep((jx, jL), ju), tstep((tx, tL), tu)
    _close(tx1, jx1, F32)
    # the lag advances exactly once per step (held across the RK4 stages)
    # and is untouched when disabled
    want_L = jthr.lag_step(jlag, jL, jthr.static_thrust(jcfg, ju))[0] if use_lag else jL
    np.testing.assert_allclose(tL1.numpy(), np.asarray(want_L), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_simulate_thruster_matches_jax(method, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag) = _models()
    x0 = np.zeros(12)
    x0[2] = 1.0
    U = np.clip(rng.normal(size=(40, 8)) * 0.4, -1, 1)
    jx, tx = _pair(x0, "float32")
    jU, tU = _pair(U, "float32")
    want = jfossen.simulate_thruster(jp, jcfg, jlag, jx, jU, 0.02, method)
    got = tfossen.simulate_thruster(tp, tcfg, tlag, tx, tU, 0.02, method)
    assert got.shape == (41, 12)
    _close(got, want, F32)


def test_simulate_wrench_matches_jax(rng):
    (jp, _, _), (tp, _, _) = _models(current=(0.1, 0.0, -0.05))
    x0 = rng.normal(size=(3, 12)) * 0.2
    TAU = rng.normal(size=(20, 3, 6)) * 3.0
    jx, tx = _pair(x0, "float32")
    jT, tT = _pair(TAU, "float32")
    want = jfossen.simulate_wrench(jp, jx, jT, 0.05, "rk4")
    got = tfossen.simulate_wrench(tp, tx, tT, 0.05, "rk4")
    _close(got, want, F32)


def test_step_factories_reject_what_is_not_ported():
    (_, _, _), (tp, tcfg, tlag) = _models()
    with pytest.raises(ValueError):
        tfossen.make_wrench_step(tp, 0.02, state="euler9")
    with pytest.raises(ValueError):
        tfossen.make_thruster_step(tp, tcfg, tlag, 0.02, method="Euler")


# --- quat13 --------------------------------------------------------------------

CURRENTS = [(0.0, 0.0, 0.0), (0.3, -0.2, 0.1)]


def _quat_states(rng, n, dtype):
    """quat13 states with unit quaternions from random Euler angles."""
    x = rng.normal(size=(n, 13)) * 0.3
    eul = rng.normal(size=(3, n)) * 0.4
    x[:, 3:7] = np.asarray(jq.euler_to_quat(*(jnp.asarray(a) for a in eul)))
    return _pair(x, dtype)


@pytest.mark.parametrize("current", CURRENTS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wrench_rhs_quat_matches_jax(dtype, current, rng):
    (jp, _, _), (tp, _, _) = _models(current=current, dtype=dtype)
    jx, tx = _quat_states(rng, 6, dtype)
    # an unnormalised quaternion too: the RHS normalises on entry
    jx, tx = jx.at[0, 3:7].multiply(1.7), tx.clone()
    tx[0, 3:7] *= 1.7
    jt, tt = _pair(rng.normal(size=(6, 6)) * 5.0, dtype)
    tol = F64 if dtype == "float64" else dict(rtol=1e-5, atol=2e-5)
    _close(tfossen.wrench_rhs_quat(tp, tx, tt), jfossen.wrench_rhs_quat(jp, jx, jt), tol)


def test_renormalize_quat13_matches_jax(rng):
    jx, tx = _quat_states(rng, 5, "float64")
    jx, tx = jx * 1.3, tx * 1.3
    got = tfossen.renormalize_quat13(tx)
    _close(got, jfossen.renormalize_quat13(jx), F64)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:7].numpy(), axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("current", CURRENTS)
@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_make_wrench_step_quat13_matches_jax(method, renormalize, current, rng):
    (jp, _, _), (tp, _, _) = _models(current=current)
    jx, tx = _quat_states(rng, 8, "float32")
    jt, tt = _pair(rng.normal(size=(8, 6)) * 3.0, "float32")
    jstep = jfossen.make_wrench_step(jp, 0.02, method, "quat13", renormalize)
    tstep = tfossen.make_wrench_step(tp, 0.02, method, "quat13", renormalize)
    _close(tstep(tx, tt), jstep(jx, jt), F32)


@pytest.mark.parametrize("current", CURRENTS)
def test_simulate_wrench_quat13_matches_jax(current, rng):
    (jp, _, _), (tp, _, _) = _models(current=current)
    jx, tx = _quat_states(rng, 3, "float32")
    jT, tT = _pair(rng.normal(size=(20, 3, 6)) * 3.0, "float32")
    want = jfossen.simulate_wrench(jp, jx, jT, 0.05, "rk4", state="quat13")
    got = tfossen.simulate_wrench(tp, tx, tT, 0.05, "rk4", state="quat13")
    assert got.shape == (21, 3, 13)
    _close(got, want, F32)
    np.testing.assert_allclose(np.linalg.norm(got[-1, :, 3:7].numpy(), axis=1), 1.0, atol=1e-6)

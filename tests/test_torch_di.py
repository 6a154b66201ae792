"""The port's DI model (``models/di.py``) against the JAX package's on the
same inputs, made with numpy from a seed.

Tolerances: float64 to rtol 1e-10 (the same operations, the ridge solve
by Cholesky on both sides; measured 7.3e-15), explicit float32 to rtol
1e-4 for the gains (measured 3.3e-6: float32 Grams summed in another
order) and atol 2e-6 for one step on states of order one (measured
6.0e-8).  The rollouts and endpoint RMSEs run 40 steps, float32 at rtol
1e-4 (measured 1.7e-7 of the largest state).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import di as jdi
from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.eval import metrics as tmetrics
from bluerov2_dynamics_tpu_torch.models import di as tdi

DT = 0.02
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
TOL = {np.float64: dict(rtol=1e-10, atol=1e-12), np.float32: dict(rtol=1e-4, atol=2e-6)}
STEPS = {"euler12": "make_step_euler12", "euler12_rk4": "make_step_euler12_rk4",
         "quat13": "make_step_quat13"}


def _data(rng, n_state, n_in, N=300):
    X = np.cumsum(rng.normal(size=(N, n_state)) * 0.05, axis=0)
    if n_state == 13:
        X[:, 3:7] = rng.normal(size=(N, 4)) * 0.1 + np.array([1.0, 0, 0, 0])
    U = rng.normal(size=(N, n_in))
    return X, U


def _gains(X, U, dtype, ridge=1e-3):
    jg = jdi.estimate_gains(jnp.asarray(X, dtype), jnp.asarray(U, dtype), DT, ridge=ridge)
    tg = tdi.estimate_gains(torch.as_tensor(X, dtype=TDTYPE[dtype]),
                            torch.as_tensor(U, dtype=TDTYPE[dtype]), DT, ridge=ridge)
    return jg, tg


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_state,n_in", [(12, 8), (12, 6), (13, 6)])
def test_estimate_gains_match_jax(dtype, n_state, n_in, rng):
    X, U = _data(rng, n_state, n_in)
    jg, tg = _gains(X, U, dtype)
    for name in ("K_lin", "K_ang"):
        got = getattr(tg, name)
        assert got.dtype == TDTYPE[dtype] and got.shape == (n_in, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jg, name)),
                                   rtol=TOL[dtype]["rtol"], atol=1e-9, err_msg=name)


def test_gram_that_is_not_positive_definite_gives_nan(rng):
    X, U = _data(rng, 12, 8)
    jg, tg = _gains(X, U, np.float64, ridge=-1e6)
    assert np.isnan(np.asarray(jg.K_lin)).all()
    assert torch.isnan(tg.K_lin).all() and torch.isnan(tg.K_ang).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", list(STEPS))
def test_steps_match_jax(dtype, variant, rng):
    n_state = 13 if variant == "quat13" else 12
    X, U = _data(rng, n_state, 6)
    jg, _ = _gains(X, U, np.float64)
    gains = {k: np.asarray(v) for k, v in jg._asdict().items()}
    tg = convert.di_gains_from_numpy(gains, dtype=TDTYPE[dtype], device="cpu")
    jstep = getattr(jdi, STEPS[variant])(jdi.DIGains(*(jnp.asarray(v, dtype) for v in
                                                         gains.values())), DT)
    tstep = getattr(tdi, STEPS[variant])(tg, DT)
    x, u = X[:64].astype(dtype), U[:64].astype(dtype)
    got = tstep(torch.from_numpy(x), torch.from_numpy(u))
    assert got.dtype == TDTYPE[dtype] and got.shape == (64, n_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstep(jnp.asarray(x), jnp.asarray(u))),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", list(STEPS))
def test_simulate_and_endpoint_rmse_match_jax(dtype, variant, rng):
    n_state = 13 if variant == "quat13" else 12
    X, U = _data(rng, n_state, 6, N=60)
    X, U = X.astype(dtype), U.astype(dtype)
    jg, tg = _gains(X, U, dtype)
    want = np.asarray(jdi.simulate(jg, jnp.asarray(X[0]), jnp.asarray(U[:40]), DT, variant))
    got = tdi.simulate(tg, torch.from_numpy(X[0]), torch.from_numpy(U[:40]), DT, variant)
    assert got.shape == (41, n_state)
    np.testing.assert_allclose(got[0].numpy(), X[0], rtol=0, atol=0)
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())
    jstep = getattr(jdi, STEPS[variant])(jg, DT)
    tstep = getattr(tdi, STEPS[variant])(tg, DT)
    tX, tU = torch.from_numpy(X), torch.from_numpy(U)
    for H in (1, 10, 40):
        np.testing.assert_allclose(
            float(tmetrics.endpoint_rmse(tstep, tX, tU, H)),
            float(jmetrics.endpoint_rmse(jstep, jnp.asarray(X), jnp.asarray(U), H)), rtol=rtol)
    assert np.isnan(float(tmetrics.endpoint_rmse(tstep, tX, tU, 60)))

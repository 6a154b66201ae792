"""The port's differentiable Fossen identification (``models/sysid.py``)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed (a recording simulated by the JAX
package's own generator for the fits) and fed to both sides.  ``conftest``
turns JAX's x64 mode on, so every float32 case names its dtype on both
sides.  Tolerances: the coefficient builder at rtol 1e-6 (float32 and
float64); the lag history at rtol 1e-6 / 1e-12; the window loss and its
gradient at a fixed point, against the JAX loss in float64, at rtol 1e-10
in float64 and 1e-4 in float32 (gradient entries at 1e-4 of the largest);
a whole fit in float64
(loss history and log-scales) at rtol 1e-8 and a float32 fit's loss
history at rtol 1e-3; the Laplace stderrs in float64 with the same
``inf`` entries and the finite ones at rtol 1e-6; the Adam step against
``optax.adam`` at rtol 1e-6 (float32) and 1e-12 (float64).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from bluerov2_dynamics_tpu.data.synthetic import generate_tank_recording
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import sysid as jsysid
from bluerov2_dynamics_tpu.models.params import lag_params as jlag_params
from bluerov2_dynamics_tpu.models.params import thruster_config as jthruster_config
from bluerov2_dynamics_tpu_torch.models import sysid
from bluerov2_dynamics_tpu_torch.models.params import (
    fossen_params,
    lag_params,
    thruster_config,
)

DT = 0.02
N_FIT = 300
ZERO_DLIN = [12, 14, 16]         # Yv, Kp, Nr: zero nominal, unidentifiable
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
LOSS_RTOL = {"float32": 1e-4, "float64": 1e-10}


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)


@pytest.fixture(scope="module")
def recording():
    """A short pseudo tank recording from the JAX package's generator
    (float64 host arrays)."""
    ds = generate_tank_recording(jax.random.PRNGKey(0), n_steps=N_FIT, dtype=jnp.float64)
    return np.array(ds.X), np.array(ds.U)


@pytest.fixture(scope="module")
def wrench_recordings():
    """euler12 and quat13 states simulated by the JAX package's wrench
    models at known scales, with their wrench inputs (float64)."""
    p_true = jsysid.params_from_scales(jnp.asarray(np.linspace(1.05, 0.95, 23)),
                                       dtype=jnp.float64)
    n = 160
    t = np.arange(n, dtype=np.float64)[:, None]
    TAU = np.concatenate([6.0 * np.sin(0.1 * t + np.arange(3.0)),
                          1.0 * np.sin(0.15 * t + np.arange(3.0))], axis=1)
    x12 = np.zeros(12)
    x13 = np.zeros(13)
    x13[3] = 1.0
    out = {}
    for state, x0 in (("euler12", x12), ("quat13", x13)):
        X = jfossen.simulate_wrench(p_true, jnp.asarray(x0), jnp.asarray(TAU), DT,
                                    method="euler", state=state)[:n]
        out[state] = (np.array(X), TAU)
    return out


# --- the coefficient builder and the lag history ---------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scales", ["ones", "linspace"])
def test_params_from_scales_matches_jax(scales, dtype):
    jd, td = DTYPES[dtype]
    s = np.ones(23) if scales == "ones" else np.linspace(0.9, 1.1, 23)
    want = jsysid.params_from_scales(jnp.asarray(s, jd), dtype=jd)
    got = sysid.params_from_scales(torch.as_tensor(s, dtype=td), dtype=td)
    for name, a, b in zip(want._fields, want, got):
        assert b.dtype == td and b.shape == tuple(np.shape(a)), name
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=0, err_msg=name)


def test_params_from_scales_at_ones_is_the_nominal_set_and_validates_its_shape():
    p, ref = sysid.params_from_scales(torch.ones(23)), fossen_params(device="cpu")
    for name, a, b in zip(ref._fields, ref, p):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match=r"shape \(23,\)"):
        sysid.params_from_scales(torch.ones(22))


def test_params_from_scales_carries_gradients_into_the_scales_and_current():
    s = torch.ones(23, dtype=torch.float64, requires_grad=True)
    c = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    p = sysid.params_from_scales(s, current=c, dtype=torch.float64)
    gs, gc = torch.autograd.grad(p.minv.sum() + p.B + p.current.sum(), (s, c))
    assert gs[1] != 0 and gs[0] != 0 and np.all(_np(gc) == 1.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lag_history_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    U = np.clip(0.4 * np.random.default_rng(1).normal(size=(60, 8)), -1, 1)
    want = jsysid.lag_history(jthruster_config(dtype=jd), jlag_params(DT, dtype=jd),
                              jnp.asarray(U, jd))
    got = sysid.lag_history(thruster_config(dtype=td, device="cpu"),
                            lag_params(DT, dtype=td, device="cpu"), torch.as_tensor(U, dtype=td))
    assert got.shape == (60, 8, 3) and got.dtype == td
    assert np.all(_np(got[0]) == 0.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6 if dtype == "float32" else 1e-12,
                               atol=1e-6 if dtype == "float32" else 1e-12)


# --- the window loss and its gradient ----------------------------------------------

THETA = {"s": np.linspace(-0.06, 0.05, 23), "g": np.linspace(0.04, -0.03, 8),
         "c": np.array([0.05, -0.03, 0.01])}
LOSS_CASES = {
    # name: (kind, keyword arguments of both loss builders)
    "thruster_euler_gains_current": ("thruster", dict(method="euler", input_delay=1,
                                                      fit_gains=True, fit_current=True)),
    "thruster_rk4_gains_current": ("thruster", dict(method="rk4", input_delay=1, fit_gains=True,
                                                    fit_current=True)),
    "thruster_euler_cold_lag": ("thruster", dict(method="euler", lag_warmup=False)),
    "wrench_euler12": ("euler12", dict(method="euler", fit_current=True)),
    "wrench_quat13": ("quat13", dict(method="euler", input_delay=1)),
}
_JAX_LOSS = {}


def _jax_loss(kind, X, U, horizon, jd, method="euler", use_lag=True, lag_warmup=True,
              fit_gains=False, fit_current=False, input_delay=0):
    """The JAX package's window loss, built as its fit_thruster and
    fit_wrench build theirs."""
    X, U = jnp.asarray(X, jd), jnp.asarray(U, jd)
    n_start = X.shape[0] - horizon - input_delay

    def params(theta):
        return jsysid.params_from_scales(jnp.exp(theta["s"]),
                                         current=theta.get("c", (0.0, 0.0, 0.0)), dtype=jd)

    if kind == "thruster":
        cfg, lag = jthruster_config(dtype=jd), jlag_params(DT, dtype=jd)
        if use_lag and lag_warmup:
            lag0 = jsysid.lag_history(cfg, lag, U)[input_delay:input_delay + n_start]
        else:
            lag0 = jnp.zeros((n_start, 8, 3), jd)

        def loss_fn(theta):
            c = cfg
            if fit_gains:
                c = cfg._replace(wrench_map=cfg.wrench_map * jnp.exp(theta["g"])[:, None])
            step = jfossen.make_thruster_step(params(theta), c, lag, DT, method, use_lag)
            return jsysid._window_loss(step, (X[:n_start], lag0), lambda carry: carry[0], X, U,
                                       horizon, n_start, input_delay)
    else:
        def loss_fn(theta):
            step = jfossen.make_wrench_step(params(theta), DT, method, kind)
            return jsysid._window_loss(step, X[:n_start], lambda carry: carry, X, U, horizon,
                                       n_start, input_delay)
    return loss_fn


def _port_loss(kind, X, U, horizon, td, **kw):
    if kind == "thruster":
        return sysid.thruster_loss(X, U, DT, horizon, dtype=td, device="cpu", **kw)
    return sysid.wrench_loss(X, U, DT, horizon, state=kind, dtype=td, device="cpu", **kw)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_window_loss_and_gradient_match_jax_value_and_grad(case, dtype, recording,
                                                           wrench_recordings):
    """The port's loss and gradient in ``dtype`` against
    ``jax.value_and_grad`` of the JAX package's loss in float64 (one
    compile a case serves both dtypes)."""
    kind, kw = LOSS_CASES[case]
    td = DTYPES[dtype][1]
    X, U = recording if kind == "thruster" else wrench_recordings[kind]
    wl = _port_loss(kind, X, U, 4, td, **kw)
    keys = sorted(wl.theta0)
    theta = {k: torch.as_tensor(THETA[k], dtype=td).requires_grad_(True) for k in keys}
    loss = wl.loss_fn(theta)
    grads = dict(zip(keys, torch.autograd.grad(loss, [theta[k] for k in keys])))
    loss = loss.detach()
    if case not in _JAX_LOSS:
        _JAX_LOSS[case] = jax.jit(jax.value_and_grad(_jax_loss(kind, X, U, 4, jnp.float64, **kw)))(
            {k: jnp.asarray(THETA[k], jnp.float64) for k in keys})
    want, jgrads = _JAX_LOSS[case]
    rtol = LOSS_RTOL[dtype]
    assert loss.dtype == td and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(want), rtol=rtol)
    for k, g in grads.items():
        jg = _np(jgrads[k])
        # zero-nominal coefficients: exactly zero gradient on both sides
        np.testing.assert_allclose(_np(g), jg, rtol=rtol, atol=rtol * np.abs(jg).max(),
                                   err_msg=k)
    assert np.all(_np(grads["s"])[ZERO_DLIN] == 0.0)


# --- whole fits ---------------------------------------------------------------------

FIT_KW = dict(horizon=3, steps=20, lr=0.05, input_delay=1)


def test_float64_fit_matches_the_jax_fit(recording):
    X, U = recording
    want = jsysid.fit_thruster(X, U, DT, fit_gains=True, fit_current=True, dtype=jnp.float64,
                               **FIT_KW)
    got = sysid.fit_thruster(X, U, DT, fit_gains=True, fit_current=True, dtype=torch.float64,
                             device="cpu", **FIT_KW)
    assert got.losses.shape == (20,) and not got.losses.requires_grad
    np.testing.assert_allclose(_np(got.losses), _np(want.losses), rtol=1e-8)
    for field in ("log_scales", "log_gains", "current"):
        w = _np(getattr(want, field))
        np.testing.assert_allclose(_np(getattr(got, field)), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max(), err_msg=field)
    np.testing.assert_allclose(_np(got.cfg.wrench_map), _np(want.cfg.wrench_map), rtol=1e-12)
    assert np.array_equal(_np(got.params.current), _np(got.current))
    for name, a, b in zip(want.params._fields, want.params, got.params):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-8, atol=1e-12, err_msg=name)


def test_float32_fit_loss_history_matches_the_jax_fit(recording):
    X, U = recording
    want = jsysid.fit_thruster(X, U, DT, dtype=jnp.float32, **FIT_KW)
    got = sysid.fit_thruster(torch.as_tensor(X, dtype=torch.float32),
                             torch.as_tensor(U, dtype=torch.float32), DT, **FIT_KW)
    assert got.losses.dtype == torch.float32 and got.log_gains is None and got.current is None
    np.testing.assert_allclose(_np(got.losses), _np(want.losses), rtol=1e-3)
    assert float(got.losses[-1]) < float(got.losses[0])
    np.testing.assert_array_equal(_np(got.log_scales)[ZERO_DLIN], np.zeros(3))


def test_wrench_fit_matches_the_jax_fit(wrench_recordings):
    X, TAU = wrench_recordings["quat13"]
    kw = dict(horizon=3, steps=10, lr=0.05, state="quat13")
    want = jsysid.fit_wrench(X, TAU, DT, dtype=jnp.float64, **kw)
    got = sysid.fit_wrench(X, TAU, DT, dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_allclose(_np(got.losses), _np(want.losses), rtol=1e-8)
    np.testing.assert_allclose(_np(got.log_scales), _np(want.log_scales), rtol=1e-8, atol=1e-10)
    assert got.cfg is None and got.log_gains is None


# --- Laplace standard errors -----------------------------------------------------

def test_laplace_stderr_matches_jax(wrench_recordings):
    X, TAU = wrench_recordings["euler12"]
    theta = {"s": 0.5 * THETA["s"], "c": THETA["c"]}
    wl = sysid.wrench_loss(X, TAU, DT, 1, fit_current=True, dtype=torch.float64, device="cpu")
    got = sysid._laplace_stderr(wl.loss_fn, {k: torch.as_tensor(v) for k, v in theta.items()},
                                wl.n_start * 12)
    want = jsysid._laplace_stderr(_jax_loss("euler12", X, TAU, 1, jnp.float64, fit_current=True),
                                  {k: jnp.asarray(v) for k, v in theta.items()},
                                  wl.n_start * 12)
    for k in ("s", "c"):
        g, w = _np(got[k]), _np(want[k])
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=k)
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-6, err_msg=k)
    assert np.all(np.isinf(_np(got["s"])[ZERO_DLIN]))


def test_laplace_stderr_linear_model_exact():
    """On a linear least-squares toy the stderrs are the textbook
    ``sqrt(diag(sigma^2 (A^T A)^-1))`` with ``L*`` as sigma^2, and scale as
    ``1/sqrt(n_resid)``."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(40, 4))
    b = A @ np.array([0.5, -1.0, 2.0, 0.0]) + 0.01 * rng.normal(size=40)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def loss_fn(theta):
        r = At @ theta["v"] - bt
        return torch.mean(r * r)

    theta = {"v": torch.as_tensor(np.linalg.lstsq(A, b, rcond=None)[0])}
    se = _np(sysid._laplace_stderr(loss_fn, theta, 40)["v"])
    L = float(loss_fn(theta))
    want = np.sqrt(np.diag(L * np.linalg.inv(A.T @ A)))
    np.testing.assert_allclose(se, want, rtol=1e-6)
    se4 = _np(sysid._laplace_stderr(loss_fn, theta, 160)["v"])
    np.testing.assert_allclose(se4, se / 2.0, rtol=1e-6)
    jse = jsysid._laplace_stderr(
        lambda th: jnp.mean((jnp.asarray(A) @ th["v"] - jnp.asarray(b)) ** 2),
        {"v": jnp.asarray(theta["v"].numpy())}, 40)["v"]
    np.testing.assert_allclose(se, _np(jse), rtol=1e-6)


# --- Adam, written out ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_adam_update_matches_optax_adam(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=5)
    grads = [rng.normal(size=5) * 10.0 ** rng.uniform(-3, 1) for _ in range(12)]
    opt = optax.adam(0.03)
    jx = jnp.asarray(x0, jd)
    state = opt.init(jx)
    tx = torch.as_tensor(x0, dtype=td)
    mu, nu = torch.zeros_like(tx), torch.zeros_like(tx)
    count = torch.zeros((), dtype=torch.float64)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g, jd), state, jx)
        jx = optax.apply_updates(jx, upd)
        sysid.adam_update([tx], [torch.as_tensor(g, dtype=td)], [mu], [nu], count, 0.03)
    assert float(count) == 12.0
    rtol = 1e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=rtol)
    np.testing.assert_allclose(_np(mu), _np(state[0].mu), rtol=rtol)
    np.testing.assert_allclose(_np(nu), _np(state[0].nu), rtol=rtol)


# --- validation -------------------------------------------------------------------

def test_fit_validation_errors(recording):
    X, U = recording
    with pytest.raises(ValueError, match=r"X must be \(N, 12\)"):
        sysid.fit_thruster(X[:, :6], U, DT, device="cpu")
    with pytest.raises(ValueError, match=r"U must be"):
        sysid.fit_thruster(X, U[:, :4], DT, device="cpu")
    with pytest.raises(ValueError, match="horizon 10 >= dataset length 5"):
        sysid.fit_thruster(X[:5], U[:5], DT, horizon=10, device="cpu")
    with pytest.raises(ValueError, match="input_delay must be 0 or 1"):
        sysid.fit_thruster(X, U, DT, input_delay=2, device="cpu")
    with pytest.raises(ValueError, match="unknown state convention"):
        sysid.fit_wrench(X, np.zeros((len(X), 6)), DT, state="rpy", device="cpu")
    with pytest.raises(ValueError, match=r"X must be \(N, 13\) for quat13"):
        sysid.fit_wrench(X, np.zeros((len(X), 6)), DT, state="quat13", device="cpu")
    with pytest.raises(ValueError, match=r"TAU must be"):
        sysid.fit_wrench(X, np.zeros((len(X), 5)), DT, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sysid.fit_thruster(X, U, DT, steps=1, device="cpu", graph=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = sysid.fit_thruster(X[:40], U[:40], DT, horizon=2, steps=2, device="cpu")
    assert res.stderr is None and res.losses.shape == (2,)


# --- which fits take the window-loss kernel --------------------------------------

def test_only_a_float32_euler_graph_fit_on_one_device_takes_the_kernel(recording, monkeypatch):
    f32 = torch.float32
    assert sysid._takes_kernel("euler", True, None, f32)
    assert not sysid._takes_kernel("rk4", True, None, f32)
    assert not sysid._takes_kernel("euler", False, None, f32)
    assert not sysid._takes_kernel("euler", True, object(), f32)
    assert not sysid._takes_kernel("euler", True, None, torch.float64)

    def refuse(*args, **kwargs):
        raise AssertionError("reached the window-loss kernel's wrapper")

    monkeypatch.setattr(sysid, "_kernel_window", refuse)
    X, U = recording
    X, U = X[:40], U[:40]
    for method in ("euler", "rk4"):
        res = sysid.fit_thruster(X, U, DT, horizon=2, steps=1, method=method, device="cpu")
        assert res.losses.shape == (1,)
    res = sysid.fit_wrench(X, np.zeros((len(X), 6)), DT, horizon=2, steps=1, device="cpu")
    assert res.losses.shape == (1,)
    with pytest.raises(ValueError, match="window-loss kernel runs Euler in float32"):
        sysid._thruster_loss(X, U, DT, 2, True, device="cpu")

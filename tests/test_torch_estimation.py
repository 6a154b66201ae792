"""The port's state estimation (``models/estimation.py``) against the JAX
package's on the same numpy-seeded inputs, on the CPU.

Every filter, the smoothers, the noise fit, MHE and the particle filter
(fed the JAX package's own draws, replayed from its key splits) run in
both packages; the JAX runs are shared through module fixtures.
Tolerances, float64 unless a case says float32: means and covariances at
rtol 1e-7 (atol 1e-12), log-likelihoods and NIS at rtol 1e-9.  The port
takes its Jacobians by reverse mode (``estimation._jac``), the JAX package
by ``jax.jacfwd``; both are exact, so the two differ only in rounding.
Measured in float64: means and covariances within 7e-15 absolute (2e-11
relative on the smallest entries), log-likelihoods within 5e-14
relative.  The explicit float32 cases hold means at atol 2e-5,
covariances at rtol 2e-4 (atol 1e-9), log-likelihoods at rtol 1e-5 and
NIS at rtol 5e-4 (measured: 3.4e-6, 1.2e-10 absolute, 1.8e-7, 8e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu.models import estimation as jest
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import koopman as jkoopman
from bluerov2_dynamics_tpu.models.params import fossen_params as jparams
from bluerov2_dynamics_tpu.ops.rotations import ssa as jssa
from bluerov2_dynamics_tpu_torch.models import estimation as est
from bluerov2_dynamics_tpu_torch.models import fossen, koopman
from bluerov2_dynamics_tpu_torch.models.params import fossen_params
from bluerov2_dynamics_tpu_torch.ops.rotations import ssa

DT = 0.05
F64 = dict(rtol=1e-7, atol=1e-12)
LL64 = dict(rtol=1e-9)
F32_MEAN = dict(rtol=0, atol=2e-5)
F32_COV = dict(rtol=2e-4, atol=1e-9)
F32_LL = dict(rtol=1e-5)
F32_NIS = dict(rtol=5e-4)


def t(a, dtype=None):
    a = np.asarray(a)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **tol)


def close_filter(got, want, mean=F64, cov=F64, ll=LL64, nis=True):
    close(got.means, want.means, **mean)
    close(got.covs, want.covs, **cov)
    close(got.loglik, want.loglik, **ll)
    if nis:
        close(got.nis, want.nis, **(ll if mean is F64 else F32_NIS))


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def linear():
    """A 4-state linear system observed in 3 channels, 60 steps."""
    rng = np.random.default_rng(7)
    n, r, m, T = 4, 2, 3, 60
    A = 0.9 * np.eye(n) + 0.05 * rng.normal(size=(n, n))
    B = 0.1 * rng.normal(size=(n, r))
    H = rng.normal(size=(m, n))
    Q, R = 0.01 * np.eye(n), 0.05 * np.eye(m)
    U = rng.normal(size=(T - 1, r))
    X = np.zeros((T, n))
    X[0] = rng.normal(size=n)
    for k in range(T - 1):
        X[k + 1] = A @ X[k] + B @ U[k] + np.linalg.cholesky(Q) @ rng.normal(size=n)
    Y = X @ H.T + rng.normal(size=(T, m)) @ np.linalg.cholesky(R).T
    return dict(A=A, B=B, H=H, Q=Q, R=R, m0=np.zeros(n), P0=np.eye(n), U=U, Y=Y, X=X)


def _lin_fns(c, torch_side: bool):
    if torch_side:
        A, B, H = t(c["A"]), t(c["B"]), t(c["H"])
        return (lambda x, u: A @ x + B @ u), (lambda x: H @ x)
    A, B, H = jnp.asarray(c["A"]), jnp.asarray(c["B"]), jnp.asarray(c["H"])
    return (lambda x, u: A @ x + B @ u), (lambda x: H @ x)


@pytest.fixture(scope="module")
def fossen_case():
    """The Fossen wrench plant (euler12, Euler steps) under a random-walk
    wrench, 120 steps, noisy full-state measurements; the truth from the
    JAX simulation."""
    rng = np.random.default_rng(3)
    T = 120
    TAU = np.clip(3.0 * np.cumsum(0.1 * rng.normal(size=(T - 1, 6)), axis=0), -5, 5)
    X = np.asarray(jfossen.simulate_wrench(jparams(dtype=jnp.float64), jnp.zeros(12), TAU, DT))
    sigma = np.repeat([0.02, 0.01, 0.02, 0.01], 3)
    Y = X + sigma * rng.normal(size=X.shape)
    m0 = X[0] + 0.05 * rng.normal(size=12)
    return dict(U=TAU, Y=Y, X=X, sigma=sigma, R=np.diag(sigma ** 2), Q=1e-8 * np.eye(12),
                m0=m0, P0=0.01 * np.eye(12))


def _steps(dtype):
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    td = torch.float64 if dtype == np.float64 else torch.float32
    return (jfossen.make_wrench_step(jparams(dtype=jd), DT, "euler", "euler12"),
            fossen.make_wrench_step(fossen_params(dtype=td, device="cpu"), DT, "euler", "euler12"))


def _args(c, dtype, keys=("Q", "R", "m0", "P0", "U", "Y")):
    return ([jnp.asarray(np.asarray(c[k], dtype)) for k in keys],
            [t(c[k], dtype) for k in keys])


@pytest.fixture(scope="module")
def fossen_runs(fossen_case):
    """JAX EKF and EKF+RTS on the Fossen case, float64 and float32."""
    out = {}
    for dtype in (np.float64, np.float32):
        jstep, _ = _steps(dtype)
        ja, _ = _args(fossen_case, dtype)
        f = jest.ekf(jstep, lambda x: x, *ja)
        out[dtype] = (f, jest.rts_smooth(jstep, ja[0], ja[4], f))
    return out


# ---------------------------------------------------------------------------
# Linear filter, UKF, RTS
# ---------------------------------------------------------------------------

def test_kalman_filter_matches_jax(linear):
    c = linear
    keys = ("A", "B", "H", "Q", "R", "m0", "P0", "U", "Y")
    want = jest.kalman_filter(*[c[k] for k in keys])
    got = est.kalman_filter(*[t(c[k]) for k in keys])
    close_filter(got, want)


def test_ukf_matches_jax_on_linear_and_equals_the_kf(linear):
    c = linear
    jstep, jh = _lin_fns(c, False)
    tstep, th = _lin_fns(c, True)
    keys = ("Q", "R", "m0", "P0", "U", "Y")
    want = jest.ukf(jstep, jh, *[c[k] for k in keys])
    got = est.ukf(tstep, th, *[t(c[k]) for k in keys])
    close_filter(got, want)
    kf = est.kalman_filter(*[t(c[k]) for k in ("A", "B", "H")], *[t(c[k]) for k in keys])
    close(got.means, kf.means, atol=1e-8)


def test_rts_and_ekf_smooth_match_jax_on_linear(linear):
    c = linear
    jstep, jh = _lin_fns(c, False)
    tstep, th = _lin_fns(c, True)
    keys = ("Q", "R", "m0", "P0", "U", "Y")
    want = jest.ekf_smooth(jstep, jh, *[c[k] for k in keys])
    got = est.ekf_smooth(tstep, th, *[t(c[k]) for k in keys])
    close(got.means, want.means, **F64)
    close(got.covs, want.covs, **F64)
    close_filter(got.filtered, want.filtered)
    d_f = np.diagonal(got.filtered.covs.numpy(), axis1=1, axis2=2)
    d_s = np.diagonal(got.covs.numpy(), axis1=1, axis2=2)
    assert np.all(d_s <= d_f + 1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_ekf_and_rts_match_jax_on_fossen(dtype, fossen_case, fossen_runs):
    _, tstep = _steps(dtype)
    _, ta = _args(fossen_case, dtype)
    got = est.ekf(tstep, lambda x: x, *ta)
    sm = est.rts_smooth(tstep, ta[0], ta[4], got)
    want, want_sm = fossen_runs[dtype]
    if dtype == np.float64:
        close_filter(got, want)
        close(sm.means, want_sm.means, **F64)
        close(sm.covs, want_sm.covs, **F64)
    else:
        assert got.means.dtype == torch.float32 and sm.covs.dtype == torch.float32
        close_filter(got, want, mean=F32_MEAN, cov=F32_COV, ll=F32_LL)
        close(sm.means, want_sm.means, **F32_MEAN)
        close(sm.covs, want_sm.covs, **F32_COV)


def test_ekf_pose_only_measurement_matches_jax(fossen_case):
    """``h`` measures position and attitude only: the velocities are
    estimated, never observed (the app's ``--measure pose``)."""
    c = dict(fossen_case)
    c["Y"] = c["Y"][:, :6]
    c["R"] = c["R"][:6, :6]
    jstep, tstep = _steps(np.float64)
    ja, ta = _args(c, np.float64)
    want = jest.ekf(jstep, lambda x: x[:6], *ja)
    got = est.ekf(tstep, lambda x: x[:6], *ta)
    close_filter(got, want)


def test_ekf_ssa_residual_hook_matches_jax(fossen_case):
    """A wrap-aware innovation on the angle channels."""
    c = dict(fossen_case)
    c["Y"] = np.concatenate([c["Y"][:, :3], np.asarray(jssa(c["Y"][:, 3:6] + 3.0)),
                             c["Y"][:, 6:]], axis=1)
    jstep, tstep = _steps(np.float64)
    ja, ta = _args(c, np.float64)

    def jres(y, yp):
        v = y - yp
        return v.at[3:6].set(jssa(v[3:6]))

    def tres(y, yp):
        v = y - yp
        return torch.cat([v[:3], ssa(v[3:6]), v[6:]])

    want = jest.ekf(jstep, lambda x: x, *ja, residual=jres)
    got = est.ekf(tstep, lambda x: x, *ta, residual=tres)
    close_filter(got, want)


def test_ukf_matches_jax_on_fossen(fossen_case):
    jstep, tstep = _steps(np.float64)
    ja, ta = _args(fossen_case, np.float64)
    close_filter(est.ukf(tstep, lambda x: x, *ta), jest.ukf(jstep, lambda x: x, *ja))


def test_nees_matches_jax(fossen_case, fossen_runs):
    for dtype, tol in ((np.float64, F64), (np.float32, dict(rtol=2e-3))):
        want = jest.nees(fossen_runs[dtype][0], np.asarray(fossen_case["X"], dtype))
        res = fossen_runs[dtype][0]
        got = est.nees(est.FilterResult(t(res.means), t(res.covs), t(res.loglik), t(res.nis)),
                       t(fossen_case["X"], dtype))
        close(got, want, **tol)


def test_ekf_bank_equals_the_single_filters(fossen_case):
    """``batched=True`` is JAX's ``vmap(ekf)``: each row against the JAX
    filter of its segment."""
    _, tstep = _steps(np.float64)
    jstep, _ = _steps(np.float64)
    c = fossen_case
    m0, U, Y = est.segment_trajectory(t(c["U"]), t(c["Y"]), 30)
    got = est.ekf(tstep, lambda x: x, t(c["Q"]), t(c["R"]), m0, t(c["P0"]), U, Y, batched=True)
    assert got.means.shape == (4, 30, 12) and got.loglik.shape == (4,)
    for b in (0, 3):
        want = jest.ekf(jstep, lambda x: x, c["Q"], c["R"], m0[b].numpy(), c["P0"],
                        U[b].numpy(), Y[b].numpy())
        close_filter(est.FilterResult(got.means[b], got.covs[b], got.loglik[b], got.nis[b]), want)


def test_segment_trajectory_matches_jax(fossen_case):
    c = fossen_case
    want = jest.segment_trajectory(c["U"], c["Y"], 25)
    got = est.segment_trajectory(t(c["U"]), t(c["Y"]), 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Koopman Kalman filter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def koopman_case(fossen_case):
    """A small EDMDc model (12 RBFs, lifted dimension 24) with and without
    a fitted decoder, fitted by the JAX package on the Fossen case."""
    c = fossen_case
    X = jnp.asarray(c["X"], jnp.float32)
    U = jnp.asarray(np.concatenate([c["U"], c["U"][-1:]]), jnp.float32)
    model = jkoopman.fit(jax.random.PRNGKey(0), X, U, n_rbfs=12, gamma=1.0, ridge=1e-3)
    return model, jkoopman.fit_decoder(model, X, ridge=1e-3)


def _torch_model(jm):
    conv = lambda a: None if a is None else t(a)  # noqa: E731
    return koopman.KoopmanModel(t(jm.centers), t(jm.gamma), t(jm.A), t(jm.B),
                                conv(jm.decoder), conv(jm.rbf_weights))


@pytest.mark.parametrize("decoder", [False, True], ids=["identity", "decoder"])
def test_koopman_kalman_filter_matches_jax(decoder, koopman_case, fossen_case):
    jm = koopman_case[decoder]
    c = fossen_case
    U = np.asarray(c["U"], np.float32)
    Y = np.asarray(c["Y"], np.float32)
    R = np.asarray(c["R"], np.float32)
    want = jest.koopman_kalman_filter(jm, R, U, Y, q=1e-5)
    got = est.koopman_kalman_filter(_torch_model(jm), t(R), t(U), t(Y), q=1e-5)
    close_filter(got, want, mean=F32_MEAN, cov=F32_COV, ll=F32_LL)


def test_koopman_readout_is_the_measurement_jacobian(koopman_case):
    """The lifted filter measures through the readout itself, which is the
    exact Jacobian of the linear measurement (JAX takes ``jacfwd``)."""
    for jm in koopman_case:
        tm = _torch_model(jm)
        Hm = est.koopman_readout(tm)
        z = torch.randn(tm.lift_dim, generator=torch.Generator().manual_seed(0))
        J, _ = est._jac(lambda zz: Hm @ zz, z, tm.state_dim)
        np.testing.assert_array_equal(J.numpy(), Hm.numpy())
        Jj = jax.jacfwd(lambda zz: (jm.decoder if jm.decoder is not None else jnp.eye(
            tm.state_dim, tm.lift_dim, dtype=jnp.float32)) @ zz)(jnp.asarray(z.numpy()))
        np.testing.assert_array_equal(np.asarray(Jj), Hm.numpy())


# ---------------------------------------------------------------------------
# Noise identification
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def noise_case(linear):
    """A bank of 4 linear trajectories, 25 steps each, and the JAX fit:
    3 Adam steps of Q and R from mismatched seeds, its first gradient."""
    c = linear
    _, U, Y = jest.segment_trajectory(c["U"], c["Y"], 15)
    m0 = jnp.asarray(c["X"][0:60:15])          # the states at the segment starts
    jstep, jh = _lin_fns(c, False)
    kw = dict(q0=np.full(4, 3e-3), r0=0.1, steps=3, lr=0.1)
    fit = jest.fit_noise(jstep, jh, m0, c["P0"], U, Y, **kw)

    def negll(theta):
        Qm, Rm = jnp.diag(jnp.exp(theta["log_q"])), jnp.diag(jnp.exp(theta["log_r"]))
        ll = jax.vmap(lambda a, b, y: jest.ekf(jstep, jh, Qm, Rm, a, c["P0"], b, y).loglik)(
            m0, U, Y)
        return -jnp.sum(ll) / (Y.shape[0] * Y.shape[1])

    theta0 = {"log_q": jnp.log(jnp.full(4, 3e-3)), "log_r": jnp.log(jnp.full(3, 0.1))}
    return (np.asarray(m0), np.asarray(U), np.asarray(Y)), kw, fit, jax.jit(jax.grad(negll))(theta0)


def test_fit_noise_matches_jax(noise_case, linear):
    (m0, U, Y), kw, want, _ = noise_case
    tstep, th = _lin_fns(linear, True)
    got = est.fit_noise(tstep, th, t(m0), t(linear["P0"]), t(U), t(Y), **kw)
    close(got.losses, want.losses, rtol=1e-9)
    close(got.log_q, want.log_q, rtol=1e-9)
    close(got.log_r, want.log_r, rtol=1e-9)
    close(got.Q, want.Q, rtol=1e-9)


def test_fit_noise_first_gradient_matches_jax_grad(noise_case, linear):
    """The gradient through the filter (reverse mode over the reverse-mode
    Jacobians) against ``jax.grad`` of the same negative log-likelihood."""
    (m0, U, Y), _, _, want = noise_case
    tstep, th = _lin_fns(linear, True)
    theta = {"log_q": torch.log(torch.full((4,), 3e-3, dtype=torch.float64)).requires_grad_(),
             "log_r": torch.log(torch.full((3,), 0.1, dtype=torch.float64)).requires_grad_()}
    Qm, Rm = torch.diag(torch.exp(theta["log_q"])), torch.diag(torch.exp(theta["log_r"]))
    ll = est.ekf(tstep, th, Qm, Rm, t(m0), t(linear["P0"]), t(U), t(Y), batched=True).loglik
    loss = -torch.sum(ll) / (Y.shape[0] * Y.shape[1])
    gq, gr = torch.autograd.grad(loss, [theta["log_q"], theta["log_r"]])
    close(gq, want["log_q"], rtol=1e-9, atol=1e-14)
    close(gr, want["log_r"], rtol=1e-9, atol=1e-14)


def test_fit_noise_gradient_through_the_fossen_jacobian(fossen_case):
    """On the Fossen plant the gradient also flows through the step's
    Jacobian at the filtered means (second derivatives of the step):
    the port's against ``jax.grad`` on a 3-segment bank."""
    c = fossen_case
    jstep, tstep = _steps(np.float64)
    m0, U, Y = jest.segment_trajectory(c["U"][:59], c["Y"][:60], 20)

    def jnegll(lq):
        ll = jax.vmap(lambda a, b, y: jest.ekf(jstep, lambda x: x, jnp.diag(jnp.exp(lq)),
                                               c["R"], a, c["P0"], b, y).loglik)(m0, U, Y)
        return -jnp.sum(ll)

    lq0 = np.log(np.full(12, 1e-4))
    want = jax.jit(jax.grad(jnegll))(jnp.asarray(lq0))
    lq = t(lq0).requires_grad_()
    ll = est.ekf(tstep, lambda x: x, torch.diag(torch.exp(lq)), t(c["R"]), t(m0), t(c["P0"]),
                 t(U), t(Y), batched=True).loglik
    (got,) = torch.autograd.grad(-torch.sum(ll), lq)
    close(got, want, rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# Manifold EKF / RTS, MEKF
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quat_case():
    """The quat13 wrench plant, 100 steps, full-state quat13 measurements
    (attitude noise as a random small rotation); the truth and the
    measurement from the JAX package."""
    from bluerov2_dynamics_tpu.ops.quaternion import quat_exp, quat_multiply

    rng = np.random.default_rng(9)
    T = 100
    TAU = np.clip(3.0 * np.cumsum(0.1 * rng.normal(size=(T - 1, 6)), axis=0), -5, 5)
    x0 = np.zeros(13)
    x0[3] = 1.0
    X = np.asarray(jfossen.simulate_wrench(jparams(dtype=jnp.float64), jnp.asarray(x0), TAU, DT,
                                           state="quat13"))
    Y = X.copy()
    Y[:, 0:3] += 0.02 * rng.normal(size=(T, 3))
    Y[:, 3:7] = np.asarray(quat_multiply(X[:, 3:7], quat_exp(0.01 * rng.normal(size=(T, 3)))))
    Y[:, 7:13] += 0.02 * rng.normal(size=(T, 6))
    R = np.diag(np.concatenate([np.full(3, 0.02 ** 2), np.full(3, 0.01 ** 2),
                                np.full(6, 0.02 ** 2)]))
    return dict(U=TAU, Y=Y, X=X, R=R, Q=1e-8 * np.eye(12), P0=0.01 * np.eye(12))


def _quat_steps():
    return (jfossen.make_wrench_step(jparams(dtype=jnp.float64), DT, "euler", "quat13"),
            fossen.make_wrench_step(fossen_params(dtype=torch.float64, device="cpu"), DT, "euler",
                                    "quat13"))


def test_mekf_quat13_and_manifold_rts_match_jax(quat_case):
    c = quat_case
    jstep, tstep = _quat_steps()
    want = jest.mekf_quat13(jstep, c["Q"], c["R"], c["Y"][0], c["P0"], c["U"], c["Y"])
    got = est.mekf_quat13(tstep, t(c["Q"]), t(c["R"]), t(c["Y"][0]), t(c["P0"]), t(c["U"]),
                          t(c["Y"]))
    close_filter(got, want)
    np.testing.assert_allclose(np.linalg.norm(got.means[:, 3:7].numpy(), axis=-1), 1.0,
                               atol=1e-12)
    want_s = jest.manifold_rts_smooth(jstep, c["Q"], c["U"], want,
                                      boxplus=jest.quat13_boxplus, boxminus=jest.quat13_boxminus)
    got_s = est.manifold_rts_smooth(tstep, t(c["Q"]), t(c["U"]), got,
                                    boxplus=est.quat13_boxplus, boxminus=est.quat13_boxminus)
    close(got_s.means, want_s.means, **F64)
    close(got_s.covs, want_s.covs, **F64)


def test_quat13_box_operators_match_jax(quat_case):
    rng = np.random.default_rng(4)
    X = quat_case["Y"][:20]
    D = 0.1 * rng.normal(size=(20, 12))
    for jf, tf, a, b in ((jest.quat13_boxplus, est.quat13_boxplus, X, D),
                         (jest.quat13_boxminus, est.quat13_boxminus, X, quat_case["X"][:20]),
                         (jest.quat13_residual, est.quat13_residual, X, quat_case["X"][:20])):
        close(tf(t(a), t(b)), jax.vmap(jf)(a, b), rtol=1e-13, atol=1e-15)


def test_manifold_ekf_and_rts_with_euclidean_boxes_match_jax(fossen_case):
    c = fossen_case
    jstep, tstep = _steps(np.float64)
    ja, ta = _args(c, np.float64)
    want = jest.manifold_ekf(jstep, lambda x: x, *ja, boxplus=lambda x, d: x + d,
                             boxminus=lambda a, b: a - b)
    got = est.manifold_ekf(tstep, lambda x: x, *ta, boxplus=lambda x, d: x + d,
                           boxminus=lambda a, b: a - b)
    close_filter(got, want)
    close_filter(got, est.ekf(tstep, lambda x: x, *ta))
    want_s = jest.manifold_rts_smooth(jstep, ja[0], ja[4], want, boxplus=lambda x, d: x + d,
                                      boxminus=lambda a, b: a - b)
    got_s = est.manifold_rts_smooth(tstep, ta[0], ta[4], got, boxplus=lambda x, d: x + d,
                                    boxminus=lambda a, b: a - b)
    close(got_s.means, want_s.means, **F64)
    close(got_s.covs, want_s.covs, **F64)


# ---------------------------------------------------------------------------
# Particle filter on the JAX package's draws
# ---------------------------------------------------------------------------

def jax_pf_draws(key, T: int, N: int, n: int, dtype):
    """``particle_filter``'s draws, replayed from its key splits: the
    initial normals, then per step the resampling uniform and the process
    normals."""
    k0, key = jax.random.split(key)
    init = jax.random.normal(k0, (N, n), dtype)
    normals, uniforms = [], []
    for _ in range(T - 1):
        key, k_rs, k_prop = jax.random.split(key, 3)
        uniforms.append(jax.random.uniform(k_rs, (), dtype))
        normals.append(jax.random.normal(k_prop, (N, n), dtype))
    return np.asarray(init), np.stack(normals), np.asarray(uniforms)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_particle_filter_matches_jax_on_its_draws(dtype, linear):
    """float64 with resampling firing (ESS threshold 0.5); float32 with
    ``ess_frac=0``: resampling is discontinuous where float32 cumulative
    sums tie, so only the weighting and propagation are held there."""
    c = linear
    N, T = 64, 40
    ess_frac = 0.5 if dtype == np.float64 else 0.0
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    keys = ("Q", "R", "m0", "P0")
    jstep, jh = _lin_fns({k: np.asarray(c[k], dtype) for k in ("A", "B", "H")}, False)
    tstep, th = _lin_fns({k: np.asarray(c[k], dtype) for k in ("A", "B", "H")}, True)
    args = [np.asarray(c[k], dtype) for k in keys] + [np.asarray(c["U"][:T - 1], dtype),
                                                       np.asarray(c["Y"][:T], dtype)]
    key = jax.random.PRNGKey(5)
    want = jest.particle_filter(jstep, jh, *[jnp.asarray(a) for a in args], n_particles=N,
                                key=key, ess_frac=ess_frac)
    init, normals, uniforms = jax_pf_draws(key, T, N, 4, jd)
    got = est.particle_filter_from_draws(tstep, th, *[t(a) for a in args], t(init), t(normals),
                                         t(uniforms), ess_frac=ess_frac)
    if dtype == np.float64:
        assert float(np.min(np.asarray(want.ess)[:-1])) < 0.5 * N     # resampling fired
        close(got.means, want.means, **F64)
        close(got.covs, want.covs, **F64)
        close(got.ess, want.ess, rtol=1e-9)
        close(got.loglik, want.loglik, **LL64)
    else:
        close(got.means, want.means, rtol=0, atol=1e-4)
        close(got.ess, want.ess, rtol=1e-3)
        close(got.loglik, want.loglik, rtol=1e-5)


def test_particle_filter_is_deterministic_and_banks_are_per_trajectory(linear):
    c = linear
    tstep, th = _lin_fns(c, True)
    args = [t(c[k]) for k in ("Q", "R", "m0", "P0", "U", "Y")]
    a = est.particle_filter(tstep, th, *args, n_particles=32, seed=3)
    b = est.particle_filter(tstep, th, *args, n_particles=32, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, U, Y = est.segment_trajectory(args[4], args[5], 20)
    m0 = t(c["X"][0:60:20])
    bank = est.particle_filter_bank(tstep, th, *args[:2], m0, args[3], U, Y, n_particles=32,
                                    seed=3)
    part = est.particle_filter_bank(tstep, th, *args[:2], m0[1:], args[3], U[1:], Y[1:],
                                    n_particles=32, seed=3, indices=[1, 2])
    for x, y in zip(bank, part):
        torch.testing.assert_close(x[1:], y, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# MHE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("meas_loss", ["quadratic", "huber"])
def test_mhe_matches_jax(meas_loss, linear):
    """A 14-step case with window 5: the first window's 12 iterations from
    zero, then 4 a window, Adam restarted at every window."""
    c = linear
    T = 14
    jstep, jh = _lin_fns(c, False)
    tstep, th = _lin_fns(c, True)
    args = [c[k] for k in ("Q", "R", "m0", "P0")] + [c["U"][:T - 1], c["Y"][:T]]
    kw = dict(window=5, iters=4, init_iters=12, lr=0.05, meas_loss=meas_loss, huber_delta=1.0)
    want = jest.mhe(jstep, jh, *args, **kw)
    got = est.mhe(tstep, th, *[t(a) for a in args], **kw)
    close(got.means, want.means, rtol=1e-9, atol=1e-12)
    close(got.losses, want.losses, rtol=1e-9)


def test_mhe_huber_on_fossen_with_outliers_matches_jax(fossen_case):
    """The Fossen plant, 5% of the samples 50-sigma outliers, window 6 and
    the Huber penalty (the app's ``--filter mhe --outlier-frac``), float64:
    means at atol 1e-10 (measured 6e-12 after 35 windows of Adam, whose
    normalised update carries rounding on), losses at rtol 1e-9."""
    c = fossen_case
    rng = np.random.default_rng(17)
    T = 40
    Y = c["Y"][:T] + np.where(rng.random((T, 12)) < 0.05,
                              50.0 * c["sigma"] * np.sign(rng.normal(size=(T, 12))), 0.0)
    jstep, tstep = _steps(np.float64)
    args = [1e-4 * np.eye(12), c["R"], Y[0], c["P0"], c["U"][:T - 1], Y]
    kw = dict(window=6, iters=3, init_iters=60, meas_loss="huber")
    want = jest.mhe(jstep, lambda x: x, *args, **kw)
    got = est.mhe(tstep, lambda x: x, *[t(a) for a in args], **kw)
    close(got.means, want.means, rtol=0, atol=1e-10)
    close(got.losses, want.losses, rtol=1e-9)


def test_mhe_window_equal_to_the_record(linear):
    c = linear
    tstep, th = _lin_fns(c, True)
    jstep, jh = _lin_fns(c, False)
    args = [c[k] for k in ("Q", "R", "m0", "P0")] + [c["U"][:5], c["Y"][:6]]
    want = jest.mhe(jstep, jh, *args, window=6, iters=2, init_iters=5)
    got = est.mhe(tstep, th, *[t(a) for a in args], window=6, iters=2, init_iters=5)
    assert got.means.shape == (6, 4) and got.losses.shape == (1,)
    close(got.means, want.means, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def test_every_value_error_of_the_jax_functions(linear):
    c = linear
    tstep, th = _lin_fns(c, True)
    Q, R, m0, P0, U, Y = [t(c[k]) for k in ("Q", "R", "m0", "P0", "U", "Y")]
    A, B, H = t(c["A"]), t(c["B"]), t(c["H"])
    short = U[:-3]
    box = dict(boxplus=lambda x, d: x + d, boxminus=lambda a, b: a - b)
    for fn in (lambda: est.kalman_filter(A, B, H, Q, R, m0, P0, short, Y),
               lambda: est.ekf(tstep, th, Q, R, m0, P0, short, Y),
               lambda: est.ukf(tstep, th, Q, R, m0, P0, short, Y),
               lambda: est.particle_filter(tstep, th, Q, R, m0, P0, short, Y, n_particles=8),
               lambda: est.mhe(tstep, th, Q, R, m0, P0, short, Y),
               lambda: est.manifold_ekf(tstep, th, Q, R, m0, P0, short, Y, **box),
               lambda: est.segment_trajectory(short, Y, 10)):
        with pytest.raises(ValueError, match="T-1"):
            fn()
    with pytest.raises(ValueError, match="transition inputs per trajectory"):
        est.ekf(tstep, th, Q, R, m0[None], P0, short[None], Y[None], batched=True)
    with pytest.raises(ValueError, match="meas_loss"):
        est.mhe(tstep, th, Q, R, m0, P0, U, Y, meas_loss="l1")
    with pytest.raises(ValueError, match="window"):
        est.mhe(tstep, th, Q, R, m0, P0, U, Y, window=1)
    with pytest.raises(ValueError, match="segment length"):
        est.segment_trajectory(U, Y, 1)
    with pytest.raises(ValueError, match="fit_q/fit_r"):
        est.fit_noise(tstep, th, m0, P0, U, Y, fit_q=False, fit_r=False)
    with pytest.raises(ValueError, match="needs CUDA"):
        est.ekf(tstep, th, Q, R, m0, P0, U, Y, graph=True)

"""The port's control module (``models/control.py``) against the JAX
package's on the same numpy-seeded inputs, on the CPU.

Every function runs in both packages on the full nonlinear thruster-lag
plant (or a linear step where the case says so); MPPI, LQG and the adaptive
loop run on the JAX package's own draws, replayed from its key splits and
handed to the port's ``normals=``.  Both take exact derivatives (the port
by reverse mode and ``torch.func``, the JAX package by ``jacfwd``) and
solve the same Cholesky systems, so they differ in rounding only.

Tolerances: float64 at rtol 1e-8, atol 1e-10 (measured: at most 2e-11
relative on LQG's commands, 1e-14 elsewhere); the adaptive loop, whose
re-solves sit on a decayed, nearly singular Gram, at atol 1e-9 (measured
1.4e-10 on a command).  The explicit float32
cases: trim's command after 50 Adam steps at atol 5e-7 (measured 2e-8:
past ~100 steps float32 Adam wanders at its floor, 7e-4 apart after 400,
which is why the float32 LQR is held against the JAX package's policy),
the closed loop and trajopt at atol 1e-5 (measured 2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bluerov2_dynamics_tpu.models import control as jc
from bluerov2_dynamics_tpu.models import fossen as jf
from bluerov2_dynamics_tpu.models import koopman as jk
from bluerov2_dynamics_tpu.models.params import fossen_params as jparams
from bluerov2_dynamics_tpu.models.params import lag_params as jlag
from bluerov2_dynamics_tpu.models.params import thruster_config as jcfg
from bluerov2_dynamics_tpu_torch.models import control, fossen, koopman
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config

DT = 0.02
F64 = dict(rtol=1e-8, atol=1e-10)
ADAPTIVE = dict(rtol=1e-8, atol=1e-9)
F32 = dict(rtol=0, atol=1e-5)
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
TARGET = np.array([1.0, 0.5, -0.3] + [0.0] * 9)


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def close_all(got, want, fields, **tol):
    for f in fields:
        close(getattr(got, f), getattr(want, f), err_msg=f, **tol)


def _x(**values):
    x = np.zeros(12)
    for i, v in values.items():
        x[int(i[1:])] = v
    return x


def _get(c):
    return c[0]


def _plants(name, current=(0.0, 0.0, 0.0)):
    """The JAX and the port's lag plants, their params and configs."""
    jd, td = DTYPES[name]
    jp, jcf = jparams(current=current, dtype=jd), jcfg(dtype=jd)
    tp, tcf = (fossen_params(current=current, dtype=td, device="cpu"),
               thruster_config(dtype=td, device="cpu"))
    return dict(
        jp=jp, jcfg=jcf, tp=tp, tcfg=tcf, jd=jd, td=td,
        jstep=jf.make_thruster_step(jp, jcf, jlag(DT, dtype=jd), DT, "euler"),
        tstep=fossen.make_thruster_step(tp, tcf, lag_params(DT, dtype=td, device="cpu"), DT,
                                        "euler"),
        jinit=lambda x: (jnp.asarray(x, jd), jnp.zeros((8, 3), jd)),
        tinit=lambda x: (torch.as_tensor(x, dtype=td), torch.zeros((8, 3), dtype=td)))


@pytest.fixture(scope="module")
def f64():
    return _plants("f64")


@pytest.fixture(scope="module")
def lqr64(f64):
    """``fossen_lqr`` in both packages (float64)."""
    return (jc.fossen_lqr(f64["jp"], f64["jcfg"], DT, dtype=jnp.float64),
            control.fossen_lqr(f64["tp"], f64["tcfg"], DT, dtype=torch.float64))


# ---------------------------------------------------------------------------
# Flattening, LQR design
# ---------------------------------------------------------------------------

def test_flat_order_matches_ravel_pytree():
    rng = np.random.default_rng(0)
    x, lag = rng.normal(size=12), rng.normal(size=(8, 3))
    want, _ = ravel_pytree((jnp.asarray(x), jnp.asarray(lag)))
    carry = (torch.as_tensor(x), torch.as_tensor(lag))
    flat = control.Flat.of(carry)
    s = flat.ravel(carry)
    close(s, want, rtol=0, atol=0)
    back = flat.unravel(s)
    assert torch.equal(back[0], carry[0]) and torch.equal(back[1], carry[1])
    batch = flat.unravel(torch.stack([s, 2 * s]))         # leading batch dimensions
    assert batch[1].shape == (2, 8, 3) and torch.equal(batch[1][1], 2 * carry[1])
    assert torch.equal(flat.ravel(batch)[1], 2 * s)


def test_dlqr_matches_jax_and_scipy_dare():
    scipy_linalg = pytest.importorskip("scipy.linalg")
    rng = np.random.default_rng(0)
    n, m = 6, 3
    A = 0.95 * np.eye(n) + 0.08 * rng.normal(size=(n, n))
    B = rng.normal(size=(n, m))
    Q, R = np.eye(n), 0.5 * np.eye(m)
    K, P = control.dlqr(torch.as_tensor(A), torch.as_tensor(B), Q, R, iters=2000)
    jK, jP = jc.dlqr(jnp.asarray(A), jnp.asarray(B), Q, R, iters=2000)
    P_ref = scipy_linalg.solve_discrete_are(A, B, Q, R)
    close(P, P_ref, rtol=1e-8, atol=1e-10)
    close(K, jK, **F64)
    close(P, jP, **F64)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_linearize_exact_on_linear_step(name):
    jd, td = DTYPES[name]
    rng = np.random.default_rng(1)
    A, B = rng.normal(size=(5, 5)), rng.normal(size=(5, 2))
    tA, tB = torch.as_tensor(A, dtype=td), torch.as_tensor(B, dtype=td)
    got = control.linearize(lambda x, u: x @ tA.T + u @ tB.T, torch.zeros(5, dtype=td),
                            torch.zeros(2, dtype=td))
    close(got[0], tA, rtol=0, atol=0)
    close(got[1], tB, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_trim_matches_jax(name):
    d = _plants(name)
    ju, jr = jc.trim(d["jp"], d["jcfg"], dtype=d["jd"], steps=50)
    tu, tr = control.trim(d["tp"], d["tcfg"], dtype=d["td"], steps=50)
    tol = F64 if name == "f64" else dict(rtol=0, atol=5e-7)
    close(tu, ju, **tol)
    close(tr, jr, **(F64 if name == "f64" else dict(rtol=1e-3)))


def test_fossen_lqr_matches_jax(lqr64):
    jpol, tpol = lqr64
    close(tpol.K, jpol.K, **F64)
    close(tpol.u_eq, jpol.u_eq, **F64)
    assert (tpol.u_lo, tpol.u_hi) == (jpol.u_lo, jpol.u_hi) == (-1.0, 1.0)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=12))
    close(tpol(x), jpol(jnp.asarray(x.numpy())), **F64)


def test_koopman_dlqr_matches_jax(f64):
    """LQR on the lifted system of a JAX-fitted EDMDc model (handed to the
    port), and its closed loop."""
    rng = np.random.default_rng(3)
    U_ep = np.clip(0.03 + 0.3 * rng.normal(size=(6, 30, 8)), -1, 1)
    X_ep = np.stack([np.cumsum(0.05 * rng.normal(size=(30, 12)), axis=0) for _ in range(6)])
    jm = jk.fit_multi(jax.random.PRNGKey(1), list(jnp.asarray(X_ep)), list(jnp.asarray(U_ep)),
                      n_rbfs=10, gamma=1.0, ridge=1e-6)
    tm = koopman.KoopmanModel(*(None if v is None else torch.as_tensor(np.array(v))
                                for v in jm))
    u_eq = np.full(8, 0.02)
    jpol = jc.koopman_dlqr(jm, jnp.zeros(12), u_eq=u_eq, iters=200)
    tpol = control.koopman_dlqr(tm, torch.zeros(12, dtype=torch.float64), u_eq=u_eq, iters=200)
    close(tpol.K, jpol.K, **F64)
    close(tpol.z_ref, jpol.z_ref, **F64)
    x0 = _x(x0=0.4, x2=0.25, x5=0.4)
    jX, _ = jc.simulate_closed_loop(f64["jstep"], jpol, f64["jinit"](x0), 30, get_state=_get)
    tX, _ = control.simulate_closed_loop(f64["tstep"], tpol, f64["tinit"](x0), 30, _get)
    close(tX, jX, **F64)


# ---------------------------------------------------------------------------
# Closed loop, trajopt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f64", "f32"])
def test_simulate_closed_loop_matches_jax(name, lqr64):
    """The JAX package's hover policy (its float64 gains in ``name``'s
    dtype) in both loops, 50 steps on the lag plant."""
    d = _plants(name)
    jpol = lqr64[0]
    jpol = jpol._replace(K=jpol.K.astype(d["jd"]), u_eq=jpol.u_eq.astype(d["jd"]),
                         z_ref=jpol.z_ref.astype(d["jd"]))
    tpol = control.LQRPolicy(*(torch.as_tensor(np.array(v)) for v in jpol[:3]), -1.0, 1.0)
    x0 = _x(x0=0.5, x1=-0.4, x2=0.3, x3=0.1, x5=0.6)
    jX, jU = jc.simulate_closed_loop(d["jstep"], jpol, d["jinit"](x0), 50, get_state=_get)
    tX, tU = control.simulate_closed_loop(d["tstep"], tpol, d["tinit"](x0), 50, _get)
    assert tX.shape == (51, 12) and tU.shape == (50, 8)
    tol = F64 if name == "f64" else F32
    close(tX, jX, **tol)
    close(tU, jU, **tol)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_trajopt_matches_jax(name):
    d = _plants(name)
    kw = dict(horizon=20, steps=10, lr=0.05)
    jr = jc.trajopt(d["jstep"], np.zeros(12), TARGET, carry_init=d["jinit"], get_state=_get,
                    dtype=d["jd"], **kw)
    tr = control.trajopt(d["tstep"], np.zeros(12), TARGET, carry_init=d["tinit"],
                         get_state=_get, dtype=d["td"], device="cpu", **kw)
    close_all(tr, jr, ("losses", "U", "X"), **(F64 if name == "f64" else F32))


# ---------------------------------------------------------------------------
# MPC, MPPI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planner", ["plant", "lag-free model"])
def test_simulate_mpc_matches_jax(planner, f64):
    """5 plant steps, a 10-step plan, 3 Adam iterations a step after 5;
    planning on the plant itself or on the lag-free step while the lag
    plant executes."""
    kw = dict(sim_steps=5, horizon=10, replan_iters=3, init_iters=5, lr=0.1, get_state=_get)
    jm = tm = None
    if planner != "plant":
        jm = jf.make_thruster_step(f64["jp"], f64["jcfg"], jlag(DT, dtype=jnp.float64), DT,
                                   "euler", use_lag=False)
        tm = fossen.make_thruster_step(f64["tp"], f64["tcfg"],
                                       lag_params(DT, dtype=torch.float64, device="cpu"), DT,
                                       "euler", use_lag=False)
    x0 = _x(x0=0.5, x1=0.3, x5=0.4)
    jX, jU = jc.simulate_mpc(f64["jstep"], x0, np.zeros(12), carry_init=f64["jinit"],
                             model_step=jm, dtype=jnp.float64, **kw)
    tX, tU = control.simulate_mpc(f64["tstep"], x0, np.zeros(12), carry_init=f64["tinit"],
                                  model_step=tm, dtype=torch.float64, device="cpu", **kw)
    close(tX, jX, **F64)
    close(tU, jU, **F64)


def _mppi_normals(key, n_rounds, shape):
    """The JAX package's MPPI draws: one ``split`` of the running key a
    round, ``normal`` of the subkey."""
    out = []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float64)))
    return np.stack(out)


MPPI_KW = dict(sim_steps=5, horizon=10, n_samples=32, sigma=0.15, temperature=0.01,
               init_rounds=3, replan_rounds=2, effort_weight=1e-2)


def test_simulate_mppi_matches_jax_on_its_draws(f64):
    """The keep-out disk's indicator cost (discontinuous) as ``extra_cost``."""
    center = np.array([0.75, 0.0])
    jobs = lambda x, u: 200.0 * (jnp.linalg.norm(x[..., :2] - center, axis=-1) < 0.3)  # noqa: E731
    tc = torch.as_tensor(center)
    tobs = lambda x, u: (200.0 * (torch.linalg.norm(x[..., :2] - tc, dim=-1) < 0.3)  # noqa: E731
                         .to(x.dtype))
    x0 = _x(x0=1.5)
    jX, jU = jc.simulate_mppi(f64["jstep"], x0, np.zeros(12), extra_cost=jobs,
                              carry_init=f64["jinit"], get_state=_get, key=jax.random.PRNGKey(1),
                              dtype=jnp.float64, **MPPI_KW)
    n_rounds = MPPI_KW["init_rounds"] + MPPI_KW["sim_steps"] * MPPI_KW["replan_rounds"]
    normals = _mppi_normals(jax.random.PRNGKey(1), n_rounds, (32, 10, 8))
    tX, tU = control.simulate_mppi(f64["tstep"], x0, np.zeros(12), extra_cost=tobs,
                                   carry_init=f64["tinit"], get_state=_get, normals=normals,
                                   dtype=torch.float64, device="cpu", **MPPI_KW)
    close(tX, jX, **F64)
    close(tU, jU, **F64)
    with pytest.raises(ValueError, match="normals must have shape"):
        control.simulate_mppi(f64["tstep"], x0, np.zeros(12), carry_init=f64["tinit"],
                              get_state=_get, normals=normals[1:], dtype=torch.float64,
                              device="cpu", **MPPI_KW)


# ---------------------------------------------------------------------------
# iLQR, TVLQR
# ---------------------------------------------------------------------------

def _riccati_oracle(A, B, Q, R, P, H):
    Ks = []
    for _ in range(H):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ A - A.T @ P @ B @ K
        Ks.append(K)
    return Ks[::-1]


def test_ilqr_exact_on_lq_problem():
    """One unregularised sweep on a linear-quadratic problem is the
    optimum: the finite-horizon Riccati oracle and the JAX package."""
    rng = np.random.default_rng(3)
    n, r, H = 6, 3, 30
    A = 0.9 * np.eye(n) + 0.1 * rng.normal(size=(n, n))
    B = rng.normal(size=(n, r))
    w, wf = rng.uniform(0.5, 2.0, size=n), rng.uniform(5.0, 20.0, size=n)
    x0 = rng.normal(size=n)
    kw = dict(horizon=H, iters=1, u_limit=None, effort_weight=0.1, state_weight=w,
              terminal_weight=wf, mu0=0.0, u_dim=r)
    tA, tB = torch.as_tensor(A), torch.as_tensor(B)
    res = control.ilqr(lambda x, u: x @ tA.T + u @ tB.T, x0, np.zeros(n),
                       dtype=torch.float64, device="cpu", **kw)
    jres = jc.ilqr(lambda x, u: x @ jnp.asarray(A).T + u @ jnp.asarray(B).T, x0, np.zeros(n),
                   dtype=jnp.float64, **kw)
    Q, R = np.diag(w), 0.1 * np.eye(r)
    Ks = _riccati_oracle(A, B, Q, R, np.diag(wf), H)
    x, U_ref, cost = x0.copy(), [], 0.0
    for t in range(H):
        u = -Ks[t] @ x
        U_ref.append(u)
        cost += x @ Q @ x + u @ R @ u
        x = A @ x + B @ u
    cost += x @ np.diag(wf) @ x
    close(res.U, np.asarray(U_ref), rtol=1e-8, atol=1e-10)
    close(res.costs[-1], cost, rtol=1e-10)
    assert res.costs.shape == (2,) and res.K.shape == (H, r, n)
    close_all(res, jres, ("U", "K", "S", "costs"), **F64)


@pytest.fixture(scope="module")
def ilqr64(f64):
    kw = dict(horizon=20, iters=3, effort_weight=1e-3, get_state=_get)
    return (jc.ilqr(f64["jstep"], np.zeros(12), TARGET, carry_init=f64["jinit"],
                    dtype=jnp.float64, **kw),
            control.ilqr(f64["tstep"], np.zeros(12), TARGET, carry_init=f64["tinit"],
                         dtype=torch.float64, device="cpu", **kw))


def test_ilqr_matches_jax_on_the_lag_plant(ilqr64):
    jres, tres = ilqr64
    assert tres.K.shape == (20, 8, 36) and tres.S.shape == (21, 36)
    close_all(tres, jres, ILQR_FIELDS, **F64)
    assert np.all(np.diff(tres.costs.numpy()) <= 0.0)


ILQR_FIELDS = ("costs", "U", "X", "V", "K", "S")


def test_ilqr_rejects_a_sweep_with_nan_gains_as_jax_does(f64):
    """A negative Levenberg ``mu`` makes ``Q_uu`` indefinite: the Cholesky
    factor is NaN, every candidate (``alpha = 0`` included) is NaN and
    masked to +inf, and the sweep keeps the previous iterate; ``mu`` is
    clipped to 1e-8 for the second sweep, which improves.  The final gains,
    at the last accepted ``mu``, follow the JAX package's (NaN where its
    are)."""
    kw = dict(horizon=10, iters=2, mu0=-1e3, get_state=_get)
    target = _x(x0=0.5)
    jres = jc.ilqr(f64["jstep"], np.zeros(12), target, carry_init=f64["jinit"],
                   dtype=jnp.float64, **kw)
    tres = control.ilqr(f64["tstep"], np.zeros(12), target, carry_init=f64["tinit"],
                        dtype=torch.float64, device="cpu", **kw)
    assert float(tres.costs[1]) == float(tres.costs[0]) and tres.costs[2] < tres.costs[1]
    close_all(tres, jres, ILQR_FIELDS, **F64)


def test_simulate_tvlqr_matches_jax(ilqr64):
    """The plan executed in a current the planner never saw, with its
    gains and with the gains zeroed (open-loop replay)."""
    jres, tres = ilqr64
    cur = _plants("f64", current=(0.12, -0.08, 0.0))
    for zero in (False, True):
        jr = jres._replace(K=jnp.zeros_like(jres.K)) if zero else jres
        tr = tres._replace(K=torch.zeros_like(tres.K)) if zero else tres
        jX, jU = jc.simulate_tvlqr(cur["jstep"], jr, cur["jinit"](np.zeros(12)), get_state=_get)
        tX, tU = control.simulate_tvlqr(cur["tstep"], tr, cur["tinit"](np.zeros(12)),
                                        get_state=_get)
        close(tX, jX, **F64)
        close(tU, jU, **F64)


# ---------------------------------------------------------------------------
# LQG, adaptive Koopman-LQR
# ---------------------------------------------------------------------------

def _lqg_normals(key, steps, m):
    return np.stack([np.asarray(jax.random.normal(k, (m,), jnp.float64))
                     for k in jax.random.split(key, steps + 1)])


def test_simulate_lqg_matches_jax_on_its_draws(f64, lqr64):
    jpol, tpol = lqr64
    x0 = _x(x0=0.5, x1=-0.4, x2=0.3, x3=0.1, x5=0.6)
    steps = 20
    jres = jc.simulate_lqg(f64["jstep"], jpol, lambda x: x[:6], 1e-8, 2.5e-5,
                           f64["jinit"](x0), steps, key=jax.random.PRNGKey(0), get_state=_get)
    tres = control.simulate_lqg(f64["tstep"], tpol, lambda x: x[:6], 1e-8, 2.5e-5,
                                f64["tinit"](x0), steps, get_state=_get,
                                normals=_lqg_normals(jax.random.PRNGKey(0), steps, 6))
    close_all(tres, jres, control.LQGResult._fields, **F64)


def test_koopman_lqg_hooks_match_jax(f64, lqr64):
    """The filter on a lifted linear model of its own (``model_step``,
    ``model_state``, ``model_h``, ``m0``): Koopman-LQG."""
    rng = np.random.default_rng(4)
    d = 22
    A = 0.95 * np.eye(d) + 0.01 * rng.normal(size=(d, d))
    B = 0.05 * rng.normal(size=(d, 8))
    C = rng.normal(size=(10, 12)) * 0.3
    jm = jk.KoopmanModel(jnp.asarray(C), jnp.asarray(1.0), jnp.asarray(A), jnp.asarray(B))
    tm = koopman.KoopmanModel(torch.as_tensor(C), torch.tensor(1.0, dtype=torch.float64),
                              torch.as_tensor(A), torch.as_tensor(B))
    jpol, tpol = lqr64
    x0 = _x(x0=0.4, x2=0.25, x5=0.4)
    steps = 15
    tA, tB = tm.A, tm.B
    jres = jc.simulate_lqg(
        f64["jstep"], jpol, lambda x: x[:6], 1e-6, 2.5e-5, f64["jinit"](x0), steps,
        key=jax.random.PRNGKey(3), m0=jk.lift(jm, jnp.asarray(x0)), get_state=_get,
        model_step=lambda z, u: jnp.asarray(A) @ z + jnp.asarray(B) @ u,
        model_state=lambda z: z[:12], model_h=lambda z: z[:6])
    tres = control.simulate_lqg(
        f64["tstep"], tpol, lambda x: x[:6], 1e-6, 2.5e-5, f64["tinit"](x0), steps,
        normals=_lqg_normals(jax.random.PRNGKey(3), steps, 6),
        m0=koopman.lift(tm, torch.as_tensor(x0)), get_state=_get,
        model_step=lambda z, u: tA @ z + tB @ u, model_state=lambda z: z[:12],
        model_h=lambda z: z[:6])
    close_all(tres, jres, control.LQGResult._fields, **F64)


def test_lqg_in_loop_filter_equals_the_offline_ekf(f64, lqr64):
    """The in-loop filter is the offline EKF's update and predict: fed the
    recorded commands and measurements, ``estimation.ekf`` on the
    flattened carry returns the loop's estimates."""
    from bluerov2_dynamics_tpu_torch.models import estimation

    _, tpol = lqr64
    carry0 = f64["tinit"](_x(x0=0.5, x5=0.6))
    res = control.simulate_lqg(f64["tstep"], tpol, lambda x: x[:6], 1e-8, 2.5e-5, carry0, 15,
                               seed=0, get_state=_get)
    flat = control.Flat.of(carry0)
    s0 = flat.ravel(carry0)
    f = estimation.ekf(lambda s, u: flat.ravel(f64["tstep"](flat.unravel(s), u)),
                       lambda s: s[:6], 1e-8 * torch.eye(36, dtype=torch.float64),
                       2.5e-5 * torch.eye(6, dtype=torch.float64), s0,
                       1e-2 * torch.eye(36, dtype=torch.float64), res.U, res.Y)
    close(f.means[:, :12], res.X_est, rtol=0, atol=1e-14)
    close(f.loglik, res.loglik, rtol=1e-12)


def test_adaptive_koopman_lqr_matches_jax_on_its_dither(f64):
    """3 segments of 10 steps under a reversed half-strength thruster,
    streaming statistics seeded from 6 episodes (JAX's, handed over)."""
    rng = np.random.default_rng(5)
    u_eq = np.full(8, 0.02)
    U_ep = np.clip(u_eq + 0.3 * rng.normal(size=(6, 30, 8)), -1, 1)
    X_ep = np.stack([np.cumsum(0.05 * rng.normal(size=(31, 12)), axis=0) for _ in range(6)])
    st = jk.streaming_init(jnp.asarray(X_ep[:, ::3].reshape(-1, 12)[:10]), 1.0, input_dim=8,
                           dtype=jnp.float64)
    for Xe, Ue in zip(X_ep, U_ep):
        st = jk.streaming_update_episode(st, jnp.asarray(Xe), jnp.asarray(Ue))
    tst = koopman.KoopmanStats(*(None if v is None else torch.as_tensor(np.array(v))
                                 for v in st))
    gains = np.array([1, 1, 1, 1, 1, -0.5, 1, 1.0])
    tg = torch.as_tensor(gains)
    seg, n_seg = 10, 3
    kw = dict(steps=seg * n_seg, segment=seg, forgetting=0.99, dither=0.05, riccati_iters=50,
              get_state=_get)
    x0 = _x(x0=0.4, x2=0.25, x5=0.4)
    jr = jc.simulate_adaptive_koopman_lqr(lambda c, u: f64["jstep"](c, u * gains),
                                          f64["jinit"](x0), st, np.zeros(12), u_eq,
                                          key=jax.random.PRNGKey(2), **kw)
    normals = np.concatenate([
        np.stack([np.asarray(jax.random.normal(k, (8,), jnp.float64))
                  for k in jax.random.split(sk, seg)])
        for sk in jax.random.split(jax.random.PRNGKey(2), n_seg)])
    tr = control.simulate_adaptive_koopman_lqr(lambda c, u: f64["tstep"](c, u * tg),
                                               f64["tinit"](x0), tst, np.zeros(12), u_eq,
                                               normals=normals, **kw)
    close_all(tr, jr, ("X", "U", "K", "u_eq", "gain_deltas", "u_eqs"), **ADAPTIVE)
    close_all(tr.stats, jr.stats, ("gram", "rhs", "weight_sum"), **ADAPTIVE)


def test_value_errors_as_jax(f64, lqr64):
    jpol, tpol = lqr64
    c0 = f64["tinit"](np.zeros(12))
    with pytest.raises(ValueError, match="m0 is required"):
        control.simulate_lqg(f64["tstep"], tpol, lambda x: x[:6], 1e-8, 1e-4, c0, 5,
                             get_state=_get, model_step=lambda z, u: z)
    with pytest.raises(ValueError, match="m0 is required"):
        jc.simulate_lqg(f64["jstep"], jpol, lambda x: x[:6], 1e-8, 1e-4,
                        f64["jinit"](np.zeros(12)), 5, get_state=_get,
                        model_step=lambda z, u: z)
    st = koopman.streaming_init(torch.zeros((3, 12)), 1.0, 8, dtype=torch.float64,
                                device="cpu")
    for steps, segment in ((25, 10), (10, 0)):
        with pytest.raises(ValueError, match="positive multiple of segment"):
            control.simulate_adaptive_koopman_lqr(f64["tstep"], c0, st, np.zeros(12),
                                                  np.zeros(8), steps=steps, segment=segment,
                                                  get_state=_get)
    with pytest.raises(ValueError, match="runs eagerly"):
        control.simulate_mppi(f64["tstep"], np.zeros(12), np.zeros(12), 1, mesh=object(),
                              graph=True, device="cpu")

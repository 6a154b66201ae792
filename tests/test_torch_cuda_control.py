"""Control and guidance on the card: every CUDA-graph loop against the
eager loop, bit for bit, and the Cholesky factorisation's NaN driving
iLQR's keep-previous inside a graph.

Every case needs a CUDA device and skips without one.  The file imports no
JAX (the parity with the JAX package is ``test_torch_control.py``'s and
``test_torch_guidance.py``'s work).  A graph replays the eager loop's
kernels in the same order and the draws are made outside the graphs in
the same order on both paths, so every comparison here is bit for bit.
"""

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import control, fossen, guidance
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config

DT = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA-graph control loops")
    return torch.device("cuda")


@pytest.fixture
def plant(cuda):
    p, cfg = fossen_params(device=cuda), thruster_config(device=cuda)
    step = fossen.make_thruster_step(p, cfg, lag_params(DT, device=cuda), DT, "euler")
    return p, cfg, step


def _carry(x):
    return (x, torch.zeros((8, 3), dtype=x.dtype, device=x.device))


def _x0(cuda, **kw):
    x = torch.zeros(12, device=cuda)
    for i, v in kw.items():
        x[int(i[1:])] = v
    return x


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _get(c):
    return c[0]


@pytest.mark.cuda
def test_trim_dlqr_and_closed_loop_graphs_equal_eager(cuda, plant):
    p, cfg, step = plant
    pol = {g: control.fossen_lqr(p, cfg, DT, graph=g) for g in (True, False)}
    assert torch.equal(pol[True].K, pol[False].K) and torch.equal(pol[True].u_eq, pol[False].u_eq)
    carry0 = _carry(_x0(cuda, x0=0.5, x1=-0.4, x5=0.6))
    runs = [control.simulate_closed_loop(step, pol[True], carry0, 100, _get, graph=g)
            for g in (True, False)]
    assert _equal(*runs) and torch.isfinite(runs[0][0]).all()


@pytest.mark.cuda
def test_trajopt_graph_equals_eager(cuda, plant):
    _, _, step = plant
    target = _x0(cuda, x0=1.0, x1=0.5, x2=-0.3)
    res = [control.trajopt(step, torch.zeros(12, device=cuda), target, horizon=50, steps=5,
                           carry_init=_carry, get_state=_get, graph=g) for g in (True, False)]
    assert _equal(res[0], res[1])
    assert float(res[0].losses[-1]) < float(res[0].losses[0])


@pytest.mark.cuda
def test_mpc_graph_equals_eager(cuda, plant):
    _, _, step = plant
    kw = dict(sim_steps=2, horizon=20, replan_iters=3, init_iters=4, carry_init=_carry,
              get_state=_get)
    x0 = _x0(cuda, x0=0.5, x1=0.3, x5=0.4)
    runs = [control.simulate_mpc(step, x0, torch.zeros(12, device=cuda), graph=g, **kw)
            for g in (True, False)]
    assert _equal(*runs)


@pytest.mark.cuda
def test_mppi_graph_equals_eager_and_repeats(cuda, plant):
    _, _, step = plant
    kw = dict(sim_steps=10, horizon=15, n_samples=64, init_rounds=3, replan_rounds=2,
              carry_init=_carry, get_state=_get, seed=3)
    x0 = _x0(cuda, x0=0.3)
    runs = [control.simulate_mppi(step, x0, torch.zeros(12, device=cuda), graph=g, **kw)
            for g in (True, False, True)]
    assert _equal(runs[0], runs[1]) and _equal(runs[0], runs[2])


@pytest.mark.cuda
def test_ilqr_and_tvlqr_graphs_equal_eager(cuda, plant):
    _, _, step = plant
    target = _x0(cuda, x0=1.0, x1=0.5, x2=-0.3)
    res = [control.ilqr(step, torch.zeros(12, device=cuda), target, horizon=50, iters=2,
                        carry_init=_carry, get_state=_get, graph=g) for g in (True, False)]
    assert _equal(res[0], res[1])
    assert float(res[0].costs[-1]) < float(res[0].costs[0])
    runs = [control.simulate_tvlqr(step, res[0], _carry(torch.zeros(12, device=cuda)),
                                   get_state=_get, graph=g) for g in (True, False)]
    assert _equal(*runs)


@pytest.mark.cuda
def test_ilqr_nan_gains_keep_the_previous_iterate_inside_a_graph(cuda, plant):
    """A negative Levenberg ``mu`` makes ``Q_uu`` indefinite: the Cholesky
    factor is NaN, every line-search candidate NaN (masked to +inf), and
    the captured sweep keeps the zero plan; ``mu`` is clipped to 1e-8 for
    the next sweep, which then improves."""
    _, _, step = plant
    target = _x0(cuda, x0=0.5)
    for g in (True, False):
        res = control.ilqr(step, torch.zeros(12, device=cuda), target, horizon=20, iters=2,
                           mu0=-1e3, carry_init=_carry, get_state=_get, graph=g)
        assert float(res.costs[1]) == float(res.costs[0])
        assert float(res.costs[2]) < float(res.costs[1])


@pytest.mark.cuda
def test_lqg_graph_equals_eager(cuda, plant):
    p, cfg, step = plant
    pol = control.fossen_lqr(p, cfg, DT)
    carry0 = _carry(_x0(cuda, x0=0.5, x1=-0.4, x5=0.6))
    runs = [control.simulate_lqg(step, pol, lambda x: x[:6], 1e-8, 2.5e-5, carry0, 50,
                                 get_state=_get, graph=g) for g in (True, False)]
    assert _equal(*runs)


@pytest.mark.cuda
def test_adaptive_graph_equals_eager(cuda, plant):
    from bluerov2_dynamics_tpu_torch.models import koopman

    p, cfg, step = plant
    u_eq, _ = control.trim(p, cfg)
    rng = np.random.default_rng(0)
    centers = torch.as_tensor(0.3 * rng.normal(size=(10, 12)), dtype=torch.float32, device=cuda)
    stats0 = koopman.streaming_init(centers, 1.0, input_dim=8, device=cuda)
    for _ in range(4):
        U = torch.clamp(u_eq + 0.3 * torch.as_tensor(rng.normal(size=(40, 8)), dtype=torch.float32,
                                                      device=cuda), -1, 1)
        c, X = _carry(torch.as_tensor(0.3 * rng.normal(size=12), dtype=torch.float32,
                                      device=cuda)), []
        X.append(c[0])
        for u in U:
            c = step(c, u)
            X.append(c[0])
        stats0 = koopman.streaming_update_episode(stats0, torch.stack(X), U)
    carry0 = _carry(_x0(cuda, x0=0.4, x2=0.25, x5=0.4))
    runs = [control.simulate_adaptive_koopman_lqr(
        step, carry0, stats0, torch.zeros(12, device=cuda), u_eq, steps=40, segment=20,
        forgetting=0.99, dither=0.05, riccati_iters=50, get_state=_get, graph=g)
        for g in (True, False)]
    for f in ("X", "U", "K", "u_eq", "gain_deltas", "u_eqs"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f


@pytest.mark.cuda
def test_los_mission_graph_equals_eager(cuda, plant):
    p, cfg, step = plant
    pol = control.fossen_lqr(p, cfg, DT)
    plan = guidance.make_plan([0, 0, 0], [[0.3, 0.0, 0.3], [0.3, 0.0, 0.5], [0.3, 0.3, 0.2]],
                              accept_radius=0.1, lookahead=0.3, integral_gain=0.5, device=cuda)
    runs = [guidance.simulate_los_mission(step, pol, plan, _carry(torch.zeros(12, device=cuda)),
                                          200, get_state=_get, graph=g) for g in (True, False)]
    assert _equal(runs[0], runs[1])

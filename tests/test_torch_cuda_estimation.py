"""State estimation on the card: every CUDA-graph step loop against the
eager loop, and the Cholesky factorisation's NaN on failure.

Every case needs a CUDA device and skips without one.  The file imports
no JAX (the parity with the JAX package is ``test_torch_estimation.py``'s
work).  The graph path replays the eager loop's kernels in the same
order, so every comparison here is bit for bit.
"""

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import estimation as est
from bluerov2_dynamics_tpu_torch.models import fossen
from bluerov2_dynamics_tpu_torch.models.params import fossen_params

DT = 0.02
T = 300          # several graph chunks, the last one padded


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA-graph step loops")
    return torch.device("cuda")


def _case(device, n=T, seed=5):
    """The Fossen wrench plant, a random-walk wrench and noisy full-state
    measurements (float32)."""
    rng = np.random.default_rng(seed)
    TAU = np.clip(3.0 * np.cumsum(0.1 * rng.normal(size=(n - 1, 6)), axis=0), -5, 5)
    p = fossen_params(device="cpu")
    step = fossen.make_wrench_step(p, DT, "euler", "euler12")
    x = torch.zeros(12)
    X = [x]
    for k in range(n - 1):
        x = step(x, torch.as_tensor(TAU[k], dtype=torch.float32))
        X.append(x)
    X = torch.stack(X).numpy()
    sigma = np.repeat([1e-3, 2e-3, 1e-3, 2e-3], 3)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(step=fossen.make_wrench_step(fossen_params(device=device), DT, "euler", "euler12"),
                U=f(TAU), Y=f(X + sigma * rng.normal(size=X.shape)), R=f(np.diag(sigma ** 2)),
                Q=f(1e-6 * np.eye(12)), P0=f(1e-2 * np.eye(12)))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_ekf_and_rts_graphs_equal_the_eager_loops(cuda):
    c = _case(cuda)
    args = (c["step"], lambda x: x, c["Q"], c["R"], c["Y"][0], c["P0"], c["U"], c["Y"])
    g = est.ekf(*args, graph=True)
    e = est.ekf(*args, graph=False)
    assert _equal(g, e) and torch.isfinite(g.means).all()
    sg = est.rts_smooth(c["step"], c["Q"], c["U"], g, graph=True)
    se = est.rts_smooth(c["step"], c["Q"], c["U"], g, graph=False)
    assert torch.equal(sg.means, se.means) and torch.equal(sg.covs, se.covs)


@pytest.mark.cuda
def test_particle_filter_graph_equals_the_eager_loop_and_repeats(cuda):
    """1024 particles at 25x the sensor noise, resampling firing."""
    c = _case(cuda)
    args = (c["step"], lambda x: x, c["Q"] * 100, c["R"] * 625, c["Y"][0], c["P0"], c["U"],
            c["Y"])
    g = est.particle_filter(*args, n_particles=1024, seed=3, graph=True)
    e = est.particle_filter(*args, n_particles=1024, seed=3, graph=False)
    assert _equal(g, e)
    assert float(g.ess.min()) < 512
    assert _equal(g, est.particle_filter(*args, n_particles=1024, seed=3, graph=True))


@pytest.mark.cuda
def test_fit_noise_graph_equals_the_eager_loop(cuda):
    c = _case(cuda)
    m0, U, Y = est.segment_trajectory(c["U"], c["Y"], 50)
    kw = dict(q0=1e-6, r0=torch.diagonal(c["R"]), steps=5, lr=0.15)
    g = est.fit_noise(c["step"], lambda x: x, m0, c["P0"], U, Y, graph=True, **kw)
    e = est.fit_noise(c["step"], lambda x: x, m0, c["P0"], U, Y, graph=False, **kw)
    assert _equal(g, e) and bool(g.losses[-1] < g.losses[0])


@pytest.mark.cuda
def test_mekf_and_manifold_rts_graphs_equal_the_eager_loops(cuda):
    from bluerov2_dynamics_tpu_torch.data.csv_loader import euler_to_quat_np

    c = _case(cuda)
    X = c["Y"].double().cpu().numpy()
    q = euler_to_quat_np(X[:, 3], X[:, 4], X[:, 5])
    Y = torch.as_tensor(np.concatenate([X[:, :3], q, X[:, 6:]], 1), dtype=torch.float32,
                        device=cuda)
    step = fossen.make_wrench_step(fossen_params(device=cuda), DT, "euler", "quat13")
    args = (step, c["Q"], c["R"], Y[0], c["P0"], c["U"], Y)
    g = est.mekf_quat13(*args, graph=True)
    assert _equal(g, est.mekf_quat13(*args, graph=False))
    assert float((g.means[:, 3:7].norm(dim=-1) - 1).abs().max()) < 1e-5
    box = dict(boxplus=est.quat13_boxplus, boxminus=est.quat13_boxminus)
    sg = est.manifold_rts_smooth(step, c["Q"], c["U"], g, graph=True, **box)
    se = est.manifold_rts_smooth(step, c["Q"], c["U"], g, graph=False, **box)
    assert torch.equal(sg.means, se.means) and torch.equal(sg.covs, se.covs)


@pytest.mark.cuda
def test_mhe_graphs_equal_the_eager_loop(cuda):
    c = _case(cuda, n=30)
    args = (c["step"], lambda x: x, c["Q"] * 100, c["R"], c["Y"][0], c["P0"], c["U"], c["Y"])
    kw = dict(window=8, iters=4, init_iters=20, meas_loss="huber")
    assert _equal(est.mhe(*args, graph=True, **kw), est.mhe(*args, graph=False, **kw))


@pytest.mark.cuda
def test_cholesky_failure_is_nan_on_the_card_inside_a_graph(cuda):
    """``cholesky_ex`` reports the failure on the device; ``_chol`` turns a
    non-positive-definite matrix into NaN without a host read, so that a
    CUDA graph captures it."""
    A = torch.eye(3, device=cuda)
    A[2, 2] = -1.0
    assert torch.isnan(est._chol(A)).all()
    good = torch.eye(3, device=cuda) * 4.0
    assert torch.equal(est._chol(good), torch.eye(3, device=cuda) * 2.0)
    static = A.clone()
    est._chol(static)                       # warm the solver before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = est._chol(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isnan(out).all()

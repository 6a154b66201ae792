"""The data generator's CUDA-graph loop and the Koopman model on the card.

Every case needs a CUDA device and skips without one.  The file imports
no JAX: the card's machine has no flax, which the JAX package's ``data``
package imports, and these cases hold the card against the port's own
eager loop and float32 functions on the host CPU (the parity with the
JAX package is the CPU tests' work: ``test_torch_synthetic.py``,
``test_torch_koopman.py``).  Tolerances: the graph loop equals the eager
loop bit for bit; the card's Koopman fit and scores against the host
CPU's at rtol 1e-4 (float32 both, the normal equations in float64).
"""

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.data import synthetic as ts
from bluerov2_dynamics_tpu_torch.models import koopman as tk
from bluerov2_dynamics_tpu_torch.ops import kmeans as tkm
from bluerov2_dynamics_tpu_torch.ops import precision

K, RIDGE = 32, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA-graph loop and the card's GEMMs")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, ts.GRAPH_CHUNK, 2 * ts.GRAPH_CHUNK + 37])
def test_graph_loop_equals_the_eager_loop_on_card(n, cuda):
    draws = ts.tank_recording_draws(0, n, thruster_gain_jitter=0.1)
    graph = ts.generate_tank_recording_from_draws(draws, current=(0.1, 0.0, 0.0), device=cuda)
    eager = ts.generate_tank_recording_from_draws(draws, current=(0.1, 0.0, 0.0), device=cuda,
                                                  graph=False)
    for f in ("X", "X_true", "U"):
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    sim = ts.sim_dataset_draws(1, n)
    a = ts.generate_sim_dataset_from_draws(sim, device=cuda)
    b = ts.generate_sim_dataset_from_draws(sim, device=cuda, graph=False)
    assert torch.equal(a.X, b.X) and torch.equal(a.U, b.U)
    assert torch.equal(ts.ar1_commands_from_draws(sim["normals"].to(cuda)),
                       ts.ar1_commands_from_draws(sim["normals"].to(cuda), graph=False))


@pytest.mark.cuda
def test_card_recording_agrees_with_the_cpu_one(cuda):
    """One seed on both devices: the same draws, the same data to float32
    rounding over 300 steps."""
    a = ts.generate_tank_recording(0, n_steps=300, device=cuda)
    b = ts.generate_tank_recording(0, n_steps=300, device="cpu")
    np.testing.assert_allclose(a.X.cpu().numpy(), b.X.numpy(), rtol=0, atol=1e-5)


def _data():
    d = ts.generate_tank_recording(2, n_steps=2000, device="cpu")
    return d.X, d.U


@pytest.mark.cuda
def test_koopman_on_card_matches_the_cpu(cuda):
    X, U = _data()
    Xc, Uc = X.to(cuda), U.to(cuda)
    init = tkm.kmeans(X, K, 5, torch.Generator().manual_seed(0))[0]
    host = tk.fit(None, X, U, K, 3.0, RIDGE, 0, init=init)
    card = tk.fit(None, Xc, Uc, K, 3.0, RIDGE, 0, init=init.to(cuda))
    for H in (1, 10, 100):
        for method in ("scan", "conv"):
            np.testing.assert_allclose(
                float(tk.multistep_rmse(card, Xc, Uc, H, method=method)),
                float(tk.multistep_rmse(host, X, U, H, method=method)), rtol=1e-4)
    np.testing.assert_allclose(float(tk.evaluate(card, Xc, Uc)), float(tk.evaluate(host, X, U)),
                               rtol=1e-4)
    np.testing.assert_allclose(tk.simulate(card, Xc[5], Uc[5:55]).cpu().numpy(),
                               tk.simulate(host, X[5], U[5:55]).numpy(), rtol=0, atol=1e-4)
    stream = tk.fit_streaming(None, Xc, Uc, K, 3.0, RIDGE, 256, 0, init=init.to(cuda))
    np.testing.assert_allclose(float(tk.multistep_rmse(stream, Xc, Uc, 10)),
                               float(tk.multistep_rmse(host, X, U, 10)), rtol=1e-4)


@pytest.mark.cuda
def test_nan_guard_and_kmeans_seed_on_card(cuda):
    X, U = (t.to(cuda) for t in _data())
    init = X[:K].clone()
    models, combos = tk.fit_sweep(None, X, U, K, (3.0,), (RIDGE, -1e6), 0, init=init)
    assert bool(torch.isnan(models.A[1]).all()) and not bool(torch.isnan(models.A[0]).any())
    _, combo, rmses = tk.select_best(models, combos, X, U, 10)
    assert torch.equal(combo, combos[0]) and bool(torch.isnan(rmses[1]))
    c1, a1 = tkm.kmeans(X, K, 5, torch.Generator(cuda).manual_seed(0))
    c2, a2 = tkm.kmeans(X, K, 5, torch.Generator(cuda).manual_seed(0))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


@pytest.mark.cuda
def test_tf32_is_off_inside_the_koopman_calls_on_card(cuda):
    X, U = (t.to(cuda) for t in _data())
    model = tk.fit(None, X, U, K, 3.0, RIDGE, 0, init=X[:K].clone())
    want = float(tk.multistep_rmse(model, X, U, 10))
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        assert float(tk.multistep_rmse(model, X, U, 10)) == want
        assert precision.tf32_enabled()
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]

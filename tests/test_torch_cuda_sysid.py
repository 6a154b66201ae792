"""The Fossen identification on the card, and the window kernels K2, K4 and
K5 fed fitted coefficients, gains and a current.

Every case needs a CUDA device and skips without one.  The file imports
no JAX, flax or optax (the card's machine has neither of the last two);
the parity with the JAX package is ``test_torch_sysid.py``'s work.
Tolerances: the CUDA-graph fit against the eager loop on the card bit for
bit (the same kernels in the same order); the fit on the card against the
same fit on the host CPU at rtol 1e-3 on the loss history; the kernels'
endpoints against their plain versions at atol 2e-5 and the fused sums
at rtol 1e-5, the same bits on ten calls (``chip_smoke.py``'s bounds).
"""

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import sysid
from bluerov2_dynamics_tpu_torch.models.params import lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq

DT = 0.02
N = 2_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA-graph fit and the window kernels")
    return torch.device("cuda")


def _record(device, n=N, seed=3):
    """The pseudo tank recording (the port's generator on the host CPU)
    as float32 on ``device``: euler12 states, thruster commands, the body
    wrench and the quat13 states, as the apps T2-T6 feed them."""
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp import wrench_dataset
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import quat_dataset
    from bluerov2_dynamics_tpu_torch.data import synthetic

    rec = synthetic.generate_tank_recording(seed, n_steps=n, device="cpu")
    X, U = rec.X.double().numpy(), rec.U.double().numpy()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()  # noqa
    return f32(X), f32(U), f32(wrench_dataset(X, U)[1]), f32(quat_dataset(X, U)[0])


def _fitted(device):
    """Coefficients away from the nominal set, a current and per-thruster
    gains: what a fit hands the kernels."""
    scales = torch.exp(torch.linspace(-0.1, 0.1, 23, dtype=torch.float64))
    p = sysid.params_from_scales(scales.float(), current=(0.12, -0.08, 0.02)).to(device)
    cfg = thruster_config(device=device)
    gains = torch.exp(torch.linspace(0.1, -0.1, 8, device=device))
    return p, cfg._replace(wrench_map=cfg.wrench_map * gains[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["thruster", "quat13"])
def test_graph_fit_equals_the_eager_fit_bit_for_bit(kind, cuda):
    X, U, TAU, X13 = _record(cuda)
    kw = dict(horizon=10, steps=20, lr=0.02, input_delay=1)
    if kind == "thruster":
        fit = lambda graph: sysid.fit_thruster(X, U, DT, fit_gains=True, fit_current=True,  # noqa
                                               graph=graph, **kw)
    else:
        fit = lambda graph: sysid.fit_wrench(X13, TAU, DT, state="quat13", fit_current=True,  # noqa
                                             graph=graph, **kw)
    graph, eager = fit(True), fit(False)
    assert graph.losses.is_cuda and not graph.log_scales.requires_grad
    assert torch.equal(graph.losses, eager.losses)
    assert torch.equal(graph.log_scales, eager.log_scales)
    assert torch.equal(graph.current, eager.current)
    assert float(graph.losses[-1]) < float(graph.losses[0])


@pytest.mark.cuda
def test_fit_on_card_agrees_with_the_host_cpu(cuda):
    X, U, _, _ = _record(cuda, n=600)
    kw = dict(horizon=5, steps=10, lr=0.02, input_delay=1, fit_current=True)
    card = sysid.fit_thruster(X, U, DT, **kw)
    host = sysid.fit_thruster(X.cpu(), U.cpu(), DT, **kw)
    np.testing.assert_allclose(card.losses.cpu().numpy(), host.losses.numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_stderr_on_card_marks_the_zero_nominal_scales(cuda):
    X, U, _, _ = _record(cuda, n=400)
    res = sysid.fit_thruster(X, U, DT, horizon=3, steps=5, input_delay=1, compute_stderr=True)
    se = res.stderr["s"].cpu().numpy()
    assert np.isinf(se[[12, 14, 16]]).all() and se.dtype == np.float32


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 10, 100])
def test_window_kernels_under_fitted_values_match_their_plain_versions(H, cuda):
    X, U, TAU, X13 = _record(cuda)
    p, cfg = _fitted(cuda)
    lag = lag_params(DT, device=cuda)
    cases = {  # kernel: (endpoint fn, fused fn, plain endpoints, X, input)
        "K2 euler": (ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "euler"),
                     ce.make_endpoint_sq_cuda(p, cfg, lag, DT, H, "euler"),
                     lambda: ce.endpoint_final_plain(p, cfg, lag, X, U, DT, H, "euler"), X, U),
        "K2 rk4": (ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "rk4"),
                   ce.make_endpoint_sq_cuda(p, cfg, lag, DT, H, "rk4"),
                   lambda: ce.endpoint_final_plain(p, cfg, lag, X, U, DT, H, "rk4"), X, U),
        "K4": (ce.make_endpoint_final_cuda_wrench(p, DT, H, "euler"),
               ce.make_endpoint_sq_cuda_wrench(p, DT, H, "euler"),
               lambda: ce.endpoint_final_wrench_plain(p, X, TAU, DT, H, "euler"), X, TAU),
        "K5": (cq.make_endpoint_final_cuda_quat(p, DT, H, "euler"),
               cq.make_endpoint_sq_cuda_quat(p, DT, H, "euler"),
               lambda: cq.endpoint_final_quat_plain(p, X13, TAU, DT, H, "euler"), X13, TAU),
    }
    for name, (final_fn, sq_fn, plain, Xk, V) in cases.items():
        _build.reset_launch_counts()
        got, want = final_fn(Xk, V), plain()
        assert sum(_build.launches.values()) == 1, name
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
        sq = [sq_fn(Xk, V) for _ in range(10)]
        assert len({s.cpu().numpy().tobytes() for s in sq}) == 1, name
        np.testing.assert_allclose(float(sq[0]), float(ce.endpoint_sq(want, Xk, H)), rtol=1e-5,
                                   err_msg=name)

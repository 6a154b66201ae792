"""The Fossen identification on the card, the window-loss kernel of the
fit (``csrc/sysid_window.cu``), and the window kernels K2, K4 and K5 fed
fitted coefficients, gains and a current.

Every case needs a CUDA device and skips without one.  The file imports
no JAX, flax or optax (the card's machine has neither of the last two);
the parity with the JAX package is ``test_torch_sysid.py``'s work.
Tolerances: an autograd CUDA-graph fit (RK4, and the quat13 wrench fit)
against the eager loop on the card bit for bit (the same kernels in the
same order); the window-loss kernel against the autograd loss, its plain
version, at rtol 1e-5 on the loss and 1e-4 of the largest gradient entry
(other sums, in another order), the same bits on ten calls; the Euler
graph fit, which runs that kernel, against the eager autograd fit over 20
steps at rtol 1e-4 on the losses and atol 1e-5 on the fitted parameters;
the fit on the card against the same fit on the host CPU at rtol 1e-3 on
the loss history; the kernels' endpoints against their plain versions at
atol 2e-5 and the fused sums at rtol 1e-5, the same bits on ten calls
(``chip_smoke.py``'s bounds).  Every graph fit captures through
``ops/scan.py::capture``, on the one side stream of the device.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import sysid
from bluerov2_dynamics_tpu_torch.models.params import lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32

DT = 0.02
N = 2_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA-graph fit and the window kernels")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
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
        # RK4: an Euler graph fit takes the window-loss kernel, not autograd
        fit = lambda graph: sysid.fit_thruster(X, U, DT, method="rk4", fit_gains=True,  # noqa
                                               fit_current=True, graph=graph, **kw)
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


def _theta(gains, current, device):
    """A point away from zero: ``_fitted``'s spread of log-scales and
    log-gains, and its current."""
    theta = {"s": torch.linspace(-0.1, 0.1, 23, device=device)}
    if gains:
        theta["g"] = torch.linspace(0.1, -0.1, 8, device=device)
    if current:
        theta["c"] = torch.tensor([0.12, -0.08, 0.02], device=device)
    return theta


def _value_and_grad(loss_fn, theta):
    th = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    names = sorted(th)
    with full_f32():
        loss = loss_fn(th)
        grads = torch.autograd.grad(loss, [th[k] for k in names])
    return loss.detach(), torch.cat([g.reshape(-1) for g in grads])


# H = 3 runs a single short segment; 15 and 25 recompute one and two
# earlier segments of kSysidSegment (10) steps in the reverse pass
@pytest.mark.cuda
@pytest.mark.parametrize("H,delay,use_lag,lag_warmup,gains,current",
                         list(itertools.product((3, 10, 15, 25), (0, 1), *[(False, True)] * 4)))
def test_window_kernel_matches_the_autograd_loss_and_gradient(H, delay, use_lag, lag_warmup, gains,
                                                              current, cuda):
    X, U, _, _ = _record(cuda)
    wl, kernel_fn = sysid._thruster_loss(X, U, DT, H, True, use_lag=use_lag,
                                         lag_warmup=lag_warmup, fit_gains=gains,
                                         fit_current=current, input_delay=delay)
    theta = _theta(gains, current, cuda)
    before = _build.launches["sysid_window"]
    loss, grad = _value_and_grad(kernel_fn, theta)
    assert _build.launches["sysid_window"] == before + 1
    want_loss, want_grad = _value_and_grad(wl.loss_fn, theta)
    assert grad.shape == want_grad.shape == (23 + 8 * gains + 3 * current,)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = want_grad.cpu().numpy()
    np.testing.assert_allclose(grad.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.cuda
def test_window_kernel_gives_the_same_bits_on_ten_calls(cuda):
    X, U, _, _ = _record(cuda)
    _, kernel_fn = sysid._thruster_loss(X, U, DT, 10, True, fit_gains=True, fit_current=True,
                                        input_delay=1)
    theta = _theta(True, True, cuda)
    calls = [_value_and_grad(kernel_fn, theta) for _ in range(10)]
    assert len({(loss.cpu().numpy().tobytes(), grad.cpu().numpy().tobytes())
                for loss, grad in calls}) == 1


@pytest.mark.cuda
def test_kernel_graph_fit_matches_the_eager_autograd_fit(cuda):
    X, U, _, _ = _record(cuda)
    kw = dict(horizon=10, steps=20, lr=0.02, input_delay=1, fit_gains=True, fit_current=True)
    graph = sysid.fit_thruster(X, U, DT, graph=True, **kw)
    eager = sysid.fit_thruster(X, U, DT, graph=False, **kw)
    np.testing.assert_allclose(graph.losses.cpu().numpy(), eager.losses.cpu().numpy(), rtol=1e-4)
    for field in ("log_scales", "log_gains", "current"):
        np.testing.assert_allclose(getattr(graph, field).cpu().numpy(),
                                   getattr(eager, field).cpu().numpy(), rtol=0, atol=1e-5,
                                   err_msg=field)
    assert float(graph.losses[-1]) < float(graph.losses[0])


@pytest.mark.cuda
def test_a_kernel_fit_counts_its_replays_and_warm_up(cuda):
    X, U, _, _ = _record(cuda)
    steps = 7
    before = dict(_build.launches)
    sysid.fit_thruster(X, U, DT, horizon=10, steps=steps, lr=0.02)
    torch.cuda.synchronize()
    rose = {k: n - before[k] for k, n in _build.launches.items() if n != before[k]}
    # the capture runs none; the lag warm start is one launch of its kernel
    assert rose == {"sysid_window": steps + sysid.GRAPH_WARMUP, "lag_history": 1}


@pytest.mark.cuda
def test_graph_fits_capture_on_the_scan_modules_side_stream(cuda):
    """Two graph fits and a graph noise fit in a row capture through
    ``ops/scan.py::capture``: each capture adds its seconds to
    ``scan.STATS["capture_s"]``, one side stream serves the device, and a
    kernel fit counts ``sysid_window`` once for each warm-up iteration and
    each replay (the capture none), and ``lag_history`` once."""
    from bluerov2_dynamics_tpu_torch.models import estimation as est
    from bluerov2_dynamics_tpu_torch.models import fossen
    from bluerov2_dynamics_tpu_torch.models.params import fossen_params
    from bluerov2_dynamics_tpu_torch.ops import scan

    X, U, TAU, _ = _record(cuda)
    steps = 4
    for _ in range(2):
        before, counted = scan.STATS["capture_s"], dict(_build.launches)
        sysid.fit_thruster(X, U, DT, horizon=10, steps=steps, lr=0.02, graph=True)
        torch.cuda.synchronize()
        assert scan.STATS["capture_s"] > before
        rose = {k: n - counted[k] for k, n in _build.launches.items() if n != counted[k]}
        assert rose == {"sysid_window": steps + sysid.GRAPH_WARMUP, "lag_history": 1}
        side = scan._SIDE_STREAMS[X.device]
    step = fossen.make_wrench_step(fossen_params(device=cuda), DT, "euler", "euler12")
    m0, Us, Ys = est.segment_trajectory(TAU[:299], X[:300], 50)
    before, stats = scan.STATS["capture_s"], {}
    est.fit_noise(step, lambda x: x, m0, 1e-2 * torch.eye(12, device=cuda), Us, Ys, q0=1e-6,
                  r0=1e-4, steps=2, graph=True, stats=stats)
    assert 0 < scan.STATS["capture_s"] - before <= stats["capture_s"]
    assert [d for d in scan._SIDE_STREAMS if d == X.device] == [X.device]
    assert scan._SIDE_STREAMS[X.device] is side

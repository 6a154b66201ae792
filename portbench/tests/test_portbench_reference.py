"""The reference agrees with the port's CPU path at small sizes, in float64
where the port can run it and at float32's rounding where it cannot."""

import numpy as np
import pytest
import torch

from portbench import recording, spec
from portbench.reference import fossen as ref
from portbench.reference import tasks as rt

F64 = torch.float64
CFG = {c["name"]: spec.read_json(spec.ROOT / c["file"]) for c in spec.load_benchmark()["configs"]}
E12 = CFG["bluerov2-heavy-euler12"]
Q13 = CFG["bluerov2-heavy-quat13"]


def _port():
    from bluerov2_dynamics_tpu_torch.models import params
    return params.fossen_params(dtype=F64, device="cpu"), params.thruster_config(
        dtype=F64, device="cpu"), params.lag_params(E12["dt"], dtype=F64, device="cpu")


def test_constants_match_the_ports_nominal_set():
    p, cfg, lag = _port()
    h = ref.nominal_hydro(E12, "cpu")
    assert torch.allclose(h.minv, p.minv, rtol=1e-14, atol=0)
    assert torch.allclose(ref.wrench_map(E12), cfg.wrench_map, rtol=0, atol=1e-15)
    Ad, Bd, c = ref.zoh_lag(E12, E12["dt"])
    assert torch.allclose(Ad, lag.Ad, rtol=1e-12, atol=1e-14)
    assert torch.allclose(Bd, lag.Bd, rtol=1e-12, atol=1e-14)
    assert torch.equal(c, lag.c)
    from bluerov2_dynamics_tpu_torch.data.wrench import effectiveness_matrix
    assert np.allclose(ref.effectiveness(Q13).numpy(), effectiveness_matrix().T, atol=1e-15)


@pytest.mark.parametrize("state", ["euler12", "quat13"])
def test_right_hand_side(state):
    from bluerov2_dynamics_tpu_torch.models import fossen
    p, _, _ = _port()
    g = torch.Generator().manual_seed(3)
    n = 12 if state == "euler12" else 13
    x = 0.5 * torch.randn(64, n, generator=g, dtype=F64)
    tau = 20 * torch.randn(64, 6, generator=g, dtype=F64)
    cfg = E12 if state == "euler12" else Q13
    h = ref.nominal_hydro(cfg, "cpu")
    if state == "euler12":
        want, got = fossen.wrench_rhs_euler(p, x, tau), ref.rhs_euler12(h, x, tau)
    else:
        want, got = fossen.wrench_rhs_quat(p, x, tau), ref.rhs_quat13(h, x, tau)
    assert torch.allclose(got, want, rtol=1e-11, atol=1e-11)


def _recording(rows=400, seed=21):
    tr = spec.read_json(spec.HERE / "traffic" / "score.json")
    tr["recording"]["rows"] = rows
    return recording.generate(E12, tr, seed)


@pytest.mark.parametrize("H", [1, 7])
def test_window_rmse_float64(H):
    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.models import fossen
    p, cfg, lag = _port()
    X, U = (torch.as_tensor(a) for a in _recording())
    step = fossen.make_thruster_step(p, cfg, lag, E12["dt"], "euler")
    want = float(metrics.endpoint_rmse_carry(
        step, lambda x: torch.zeros((*x.shape[:-1], 8, 3), dtype=F64), X, U, H))
    assert rt.window_rmse(E12, X, U, H, "euler") == pytest.approx(want, rel=1e-12)


def test_quat_window_rmse_float64():
    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.models import fossen
    p, _, _ = _port()
    X13, W = (torch.as_tensor(a) for a in recording.for_state(Q13, *_recording()))
    step = fossen.make_wrench_step(p, Q13["dt"], "euler", "quat13")
    want = float(metrics.endpoint_rmse(step, X13, W, 5))
    assert rt.window_rmse(Q13, X13, W, 5, "euler") == pytest.approx(want, rel=1e-12)


def test_rollout_float64():
    from bluerov2_dynamics_tpu_torch.models import fossen
    p, cfg, lag = _port()
    g = torch.Generator().manual_seed(5)
    x0 = 0.1 * torch.randn(16, 12, generator=g, dtype=F64)
    U = torch.clamp(0.5 * torch.randn(30, 8, generator=g, dtype=F64), -1, 1)
    want = fossen.simulate_thruster(p, cfg, lag, x0, U[:, None, :].expand(30, 16, 8),
                                    E12["dt"], "rk4")[-1]
    got, cmin = rt.rollout_final(E12, x0, U[:, None, :].expand(30, 16, 8), "rk4")
    assert torch.allclose(got, want, rtol=1e-11, atol=1e-12)
    assert bool((cmin > 0).all())


def test_fit_losses_and_gradient_float64():
    from bluerov2_dynamics_tpu_torch.models import sysid
    X, U = (torch.as_tensor(a) for a in _recording(300))
    want = sysid.fit_thruster(X, U, E12["dt"], horizon=4, steps=3, lr=0.02, input_delay=0,
                              dtype=F64, device="cpu")
    lag0 = torch.as_tensor(rt.lag_history(E12, U.numpy())[:300 - 4])
    losses, theta, g0 = rt.fit(E12, X, U, 4, 3, 0.02, "euler", 0, lag0)
    assert np.allclose(losses, want.losses.numpy(), rtol=1e-10, atol=0)
    assert np.allclose(theta, want.log_scales.numpy(), rtol=1e-8, atol=1e-12)
    wl = sysid.thruster_loss(X, U, E12["dt"], 4, input_delay=0, dtype=F64, device="cpu")
    th = {k: v.clone().requires_grad_(True) for k, v in wl.theta0.items()}
    (grad,) = torch.autograd.grad(wl.loss_fn(th), [th["s"]])
    assert np.allclose(g0, grad.numpy(), rtol=1e-9, atol=1e-14)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.14159265], dtype=torch.float32)
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2.0**-9
    assert abs(float(r[3]) + 3.14159265) < 2.0**-9 * 4
    assert torch.equal(ref.round_tf32(r), r)

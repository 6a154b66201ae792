"""K5 (quat13 sliding window) and K6 (quat13 shared-wrench rollout): the
row-form plain versions against the JAX package's Pallas kernels in
interpret mode (CPU), and the CUDA kernels against the plain versions where
a card exists.

Tolerance atol 2e-5 in float32, the JAX package's own for these kernels
(tests/test_pallas_quat.py); quaternion norms after a renormalising
rollout within 1e-5 of one, as there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_quat as jpq
from bluerov2_dynamics_tpu.ops.quaternion import euler_to_quat
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq

TOL = dict(rtol=0.0, atol=2e-5)
DT = 0.02
CURRENTS = [(0.0, 0.0, 0.0), (0.2, -0.1, 0.05)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(current=(0.0, 0.0, 0.0)):
    return (jparams.fossen_params(current=current, dtype=jnp.float32),
            tparams.fossen_params(current=current, device="cpu"))


def _quat_states(rng, n):
    """quat13 states with unit quaternions, float32."""
    x = rng.normal(size=(n, 13)) * 0.3
    eul = rng.normal(size=(3, n)) * 0.4
    x[:, 3:7] = np.asarray(euler_to_quat(*(jnp.asarray(a) for a in eul)))
    return x.astype(np.float32)


def _recording(rng, jp, N=70):
    """A quat13 recording simulated by the JAX package, with sensor noise."""
    TAU = (rng.normal(size=(N, 6)) * 3.0).astype(np.float32)
    x0 = jnp.asarray(_quat_states(rng, 1)[0])
    X = np.asarray(jfossen.simulate_wrench(jp, x0, jnp.asarray(TAU), DT, state="quat13")[:-1])
    return (X + rng.normal(size=X.shape) * 1e-3).astype(np.float32), TAU


def test_normalize_q_rows_matches_jax_with_the_fallback(rng):
    q = (rng.normal(size=(64, 4)) * 2.0).astype(np.float32)
    q[:3] = 0.0
    q[1, 2] = 1e-20                                # sub-eps: identity
    q[2, 0] = 1.0                                  # unit stays unit
    want = np.stack(jpq._normalize_q_rows(*(jnp.asarray(q[:, i]) for i in range(4))), 1)
    got = torch.stack(cq.normalize_q_rows(*torch.from_numpy(q).unbind(1)), 1)
    assert np.all(np.isfinite(got.numpy()))        # rsqrt(0) never reaches a product
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=3e-7)
    np.testing.assert_array_equal(got[:3].numpy(), np.tile([1.0, 0.0, 0.0, 0.0], (3, 1)))


@pytest.mark.parametrize("current", CURRENTS)
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_plain_rollout_matches_pallas_interpret(method, current, rng):
    jp, tp = _params(current)
    x0 = _quat_states(rng, 16)
    TAU = (rng.normal(size=(50, 6)) * 3.0).astype(np.float32)
    want = jpq.make_rollout_final_pallas_quat(jp, DT, method=method, block_b=8,
                                              interpret=True)(jnp.asarray(x0), jnp.asarray(TAU))
    got = cq.rollout_final_quat_plain(tp, torch.from_numpy(x0), torch.from_numpy(TAU), DT, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:7].numpy(), axis=1), 1.0, atol=1e-5)


def test_plain_rollout_without_renormalize_matches_pallas_interpret(rng):
    jp, tp = _params()
    x0 = _quat_states(rng, 8)
    TAU = (rng.normal(size=(30, 6)) * 2.0).astype(np.float32)
    want = jpq.make_rollout_final_pallas_quat(jp, DT, method="rk4", block_b=8, interpret=True,
                                              renormalize=False)(jnp.asarray(x0), jnp.asarray(TAU))
    got = cq.rollout_final_quat_plain(tp, torch.from_numpy(x0), torch.from_numpy(TAU), DT, "rk4",
                                      renormalize=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method,renormalize", [("euler", True), ("rk4", True),
                                                ("euler", False)])
def test_plain_window_matches_pallas_interpret(method, renormalize, rng):
    jp, tp = _params(CURRENTS[1])
    X, TAU = _recording(rng, jp)
    H = 10
    want = jpq.make_endpoint_final_pallas_quat(jp, DT, H, method=method, block_b=16,
                                               interpret=True, renormalize=renormalize)(
        jnp.asarray(X), jnp.asarray(TAU))
    got = cq.endpoint_final_quat_plain(tp, torch.from_numpy(X), torch.from_numpy(TAU), DT, H,
                                       method, renormalize)
    assert got.shape == (X.shape[0] - H, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_window_rmse_matches_the_jax_step_loop(rng):
    """rsqrt in the row form against sqrt/div in the canonical step: the
    JAX kernel test's rtol 1e-4 (tests/test_pallas_quat.py)."""
    jp, tp = _params(CURRENTS[1])
    X, TAU = _recording(rng, jp)
    H = 10
    before = dict(_build.launches)
    final = cq.make_endpoint_final_cuda_quat(tp, DT, H, "euler")(
        torch.from_numpy(X), torch.from_numpy(TAU))
    assert _build.launches == before  # CPU tensors: plain version, no kernel
    got = float(torch.sqrt(torch.mean((torch.from_numpy(X[H:]) - final) ** 2)))
    step = jfossen.make_wrench_step(jp, DT, method="euler", state="quat13")
    want = float(jmetrics.endpoint_rmse(step, jnp.asarray(X), jnp.asarray(TAU), H))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cpu_rollout_takes_the_plain_version(rng):
    _, tp = _params()
    x0, TAU = torch.from_numpy(_quat_states(rng, 5)), torch.randn(12, 6)
    before = dict(_build.launches)
    got = cq.make_rollout_final_cuda_quat(tp, DT, "rk4")(x0, TAU)
    assert torch.equal(got, cq.rollout_final_quat_plain(tp, x0, TAU, DT, "rk4"))
    assert _build.launches == before


@pytest.mark.parametrize("bad,match", [("thruster_cmds", "U must be"), ("short", "rows"),
                                       ("euler12", "X must be"), ("horizon", "horizon")])
def test_window_rejects_mis_shaped_inputs(bad, match):
    _, tp = _params()
    X, TAU, H = torch.zeros(40, 13), torch.zeros(40, 6), 10
    X, TAU, H = {
        "thruster_cmds": (X, torch.zeros(40, 8), H),
        "short": (X, torch.zeros(20, 6), H),
        "euler12": (torch.zeros(40, 12), TAU, H),
        "horizon": (X, TAU, 41),
    }[bad]
    with pytest.raises(ValueError, match=match):
        cq.make_endpoint_final_cuda_quat(tp, DT, H, "euler")(X, TAU)


def test_factories_reject_unknown_methods_and_shapes():
    _, tp = _params()
    for bad in ("rk2", "Euler"):
        with pytest.raises(ValueError, match="unknown method"):
            cq.make_endpoint_final_cuda_quat(tp, DT, 10, bad)
        with pytest.raises(ValueError, match="unknown method"):
            cq.make_rollout_final_cuda_quat(tp, DT, bad)
    roll = cq.make_rollout_final_cuda_quat(tp, DT, "rk4")
    with pytest.raises(ValueError, match="x0 must be"):
        roll(torch.zeros(4, 12), torch.zeros(3, 6))
    with pytest.raises(ValueError, match="TAU must be"):
        roll(torch.zeros(4, 13), torch.zeros(3, 8))
    rc = cq.row_consts(tp, DT)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cq.launch_rollout_quat(rc, torch.zeros(4, 13), torch.zeros(3, 6), "rk4", True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cq.launch_window_eval_quat(rc, torch.zeros(20, 13), torch.zeros(20, 6), 5, "euler", True)


@pytest.mark.cuda
@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_window_kernel_matches_plain_on_card(method, renormalize, cuda, rng):
    jp, tp = _params(CURRENTS[1])
    X, TAU = _recording(rng, jp, N=300)
    p, X, TAU = tp.to(cuda), torch.from_numpy(X).to(cuda), torch.from_numpy(TAU).to(cuda)
    before = _build.launches["window_eval_quat"]
    got = cq.make_endpoint_final_cuda_quat(p, DT, 20, method, renormalize)(X, TAU)
    torch.cuda.synchronize()
    assert _build.launches["window_eval_quat"] == before + 1
    want = cq.endpoint_final_quat_plain(p, X, TAU, DT, 20, method, renormalize)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_rollout_kernel_matches_plain_on_card(method, renormalize, cuda, rng):
    _, tp = _params(CURRENTS[1])
    p = tp.to(cuda)
    x0 = torch.from_numpy(_quat_states(rng, 1000)).to(cuda)
    TAU = torch.from_numpy((rng.normal(size=(50, 6)) * 3.0).astype(np.float32)).to(cuda)
    before = _build.launches["rollout_final_quat"]
    got = cq.make_rollout_final_cuda_quat(p, DT, method, renormalize)(x0, TAU)
    torch.cuda.synchronize()
    assert _build.launches["rollout_final_quat"] == before + 1
    want = cq.rollout_final_quat_plain(p, x0, TAU, DT, method, renormalize)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if renormalize:
        np.testing.assert_allclose(torch.linalg.norm(got[:, 3:7], dim=1).cpu().numpy(), 1.0,
                                   atol=1e-5)

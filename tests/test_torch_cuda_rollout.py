"""K1, the shared-input rollout: its plain row-form version against the
JAX package's Pallas kernel in interpret mode (CPU), and the CUDA kernel
against the plain version where a card exists.

Tolerance atol 2e-5 in float32: the JAX package's own for this kernel
(tests/test_pallas_rollout.py).
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_rollout as jpr
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _models(dt=0.02, current=(0.0, 0.0, 0.0)):
    j = (jparams.fossen_params(current=current, dtype=jnp.float32),
         jparams.thruster_config(dtype=jnp.float32),
         jparams.lag_params(dt, dtype=jnp.float32))
    t = (tparams.fossen_params(current=current, device="cpu"),
         tparams.thruster_config(device="cpu"),
         tparams.lag_params(dt, device="cpu"))
    return j, t


def _inputs(rng, B, T, scale_u=0.5):
    x0 = (rng.normal(size=(B, 12)) * 0.3).astype(np.float32)
    U = np.clip(rng.normal(size=(T, 8)) * scale_u, -1, 1).astype(np.float32)
    return x0, U


@pytest.mark.parametrize("use_lag", [True, False])
def test_shared_tau_sequence_matches_jax(use_lag, rng):
    (_, jcfg, jlag), (_, tcfg, tlag) = _models()
    U = np.clip(rng.normal(size=(20, 8)), -1, 1).astype(np.float32)
    want = jpr.shared_tau_sequence(jcfg, jlag, jnp.asarray(U), use_lag)
    got = cr.shared_tau_sequence(tcfg, tlag, torch.from_numpy(U), use_lag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# the prologue's chunk edges: one step, a chunk less one, one, one more; the
# bench's T; a whole recording (36 chunks)
CHUNK_T = (1, cr.TAU_CHUNK - 1, cr.TAU_CHUNK, cr.TAU_CHUNK + 1, 500, 9_165)


@pytest.mark.parametrize("use_lag", [True, False])
@pytest.mark.parametrize("T", CHUNK_T)
def test_chunked_tau_sequence_matches_jax(T, use_lag, rng):
    """The kernel's association order (a warp-shuffle scan over lanes of 8
    steps, chunks of 256) against the JAX ``lax.scan``.  atol 2e-5 with
    rtol 1e-5: the wrench reaches ~130 N, where one float32 ulp is 7.6e-6,
    and the serial plain order itself differs from JAX by 3.4e-5 there."""
    (_, jcfg, jlag), (_, tcfg, tlag) = _models()
    U = np.clip(rng.normal(size=(T, 8)), -1, 1).astype(np.float32)
    want = np.asarray(jpr.shared_tau_sequence(jcfg, jlag, jnp.asarray(U), use_lag))
    got = cr.shared_tau_sequence_chunked(tcfg, tlag, torch.from_numpy(U), use_lag)
    assert got.shape == (T, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_chunked_tau_sequence_is_as_close_to_float64_as_the_serial_order(rng):
    """The reassociated scan loses no accuracy: against the same stored
    coefficients run in float64, its largest error over a whole recording
    is within one float32 ulp of 64 N of the serial order's."""
    _, (_, tcfg, tlag) = _models()
    U = torch.from_numpy(np.clip(rng.normal(size=(9_165, 8)), -1, 1).astype(np.float32))
    cfg64, lag64 = (type(c)(*(f.double() for f in c)) for c in (tcfg, tlag))
    exact = cr.shared_tau_sequence(cfg64, lag64, U.double())
    err_chunked = float((cr.shared_tau_sequence_chunked(tcfg, tlag, U) - exact).abs().max())
    err_serial = float((cr.shared_tau_sequence(tcfg, tlag, U) - exact).abs().max())
    assert err_chunked <= err_serial + 7.7e-6, (err_chunked, err_serial)


def test_prologue_chunk_mirrors_the_kernel_constants():
    text = (Path(cr.__file__).resolve().parent.parent / "csrc" / "rollout.cu").read_text()
    const = {m.group(1): m.group(2) for m in re.finditer(r"constexpr \w+ (k\w+) = ([^;]+);", text)}
    assert int(const["kTauChunk"]) == cr.TAU_CHUNK and int(const["kLanes"]) == cr.TAU_LANES
    assert const["kLaneSteps"] == "kTauChunk / kLanes"


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_rows_plain_matches_pallas_interpret(method, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag) = _models()
    x0, U = _inputs(rng, 16, 50)
    want = jpr.rollout_final_pallas(jp, jcfg, jlag, jnp.asarray(x0), jnp.asarray(U),
                                    0.02, method=method, block_b=8, interpret=True)
    got = cr.rollout_final_plain(tp, tcfg, tlag, torch.from_numpy(x0),
                                 torch.from_numpy(U), 0.02, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_rows_plain_nolag_matches_pallas_interpret(rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag) = _models(dt=0.05)
    x0, U = _inputs(rng, 8, 30, scale_u=1.0)
    want = jpr.rollout_final_pallas(jp, jcfg, jlag, jnp.asarray(x0), jnp.asarray(U),
                                    0.05, method="rk4", block_b=8, interpret=True,
                                    use_lag=False)
    got = cr.rollout_final_plain(tp, tcfg, tlag, torch.from_numpy(x0),
                                 torch.from_numpy(U), 0.05, "rk4", use_lag=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_rows_plain_with_ocean_current_matches_pallas_interpret(method, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag) = _models(current=(0.3, -0.2, 0.1))
    x0, U = _inputs(rng, 8, 40)
    want = jpr.rollout_final_pallas(jp, jcfg, jlag, jnp.asarray(x0), jnp.asarray(U),
                                    0.02, method=method, block_b=8, interpret=True)
    got = cr.rollout_final_plain(tp, tcfg, tlag, torch.from_numpy(x0),
                                 torch.from_numpy(U), 0.02, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # and the current changes the trajectory
    still = cr.rollout_final_plain(_models()[1][0], tcfg, tlag, torch.from_numpy(x0),
                                   torch.from_numpy(U), 0.02, method)
    assert np.abs(still.numpy() - got.numpy()).max() > 1e-3


# the edges K1 masks: T below and across a few steps, B across the block
EDGE_T, EDGE_B = (1, 3, 7), (1, 65, 130)
EDGE_RUNS = [("euler", True), ("rk4", True), ("euler", False), ("rk4", False)]
# the cases whose Pallas run at their own B differs in the last bits from the
# first rows of the run at the largest B (XLA's CPU code for another batch
# width): they keep a compile of their own
EDGE_OWN_RUN = {(7, 1, "euler", True)}
_edge_runs = {}


def _edge_case(T, B, method, use_lag):
    """The inputs of the ``(T, B)`` edge case and the Pallas kernel's
    result on them, in interpret mode: one compile and run a ``(T, method,
    use_lag)`` at the largest B, whose first B rows a smaller B takes (the
    trajectories are independent and share their commands), inputs drawn
    once a T."""
    own = (T, B, method, use_lag) in EDGE_OWN_RUN
    key = (T, B, method, use_lag) if own else (T, method, use_lag)
    if key not in _edge_runs:
        (jp, jcfg, jlag), _ = _models()
        x0, U = _inputs(np.random.default_rng(0), max(EDGE_B), T)
        if own:
            x0 = x0[:B]
        want = jpr.rollout_final_pallas(jp, jcfg, jlag, jnp.asarray(x0), jnp.asarray(U), 0.02,
                                        method=method, interpret=True, use_lag=use_lag)
        _edge_runs[key] = x0, U, np.asarray(want)
    x0, U, want = _edge_runs[key]
    return x0[:B], U, want[:B]


@pytest.mark.parametrize("method,use_lag", EDGE_RUNS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("T", EDGE_T)
def test_rows_plain_matches_pallas_at_edge_shapes(T, B, method, use_lag):
    _, (tp, tcfg, tlag) = _models()
    x0, U, want = _edge_case(T, B, method, use_lag)
    got = cr.rollout_final_plain(tp, tcfg, tlag, torch.from_numpy(x0), torch.from_numpy(U),
                                 0.02, method, use_lag=use_lag)
    assert got.shape == (B, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_cpu_tensors_take_the_plain_version(rng):
    _, (tp, tcfg, tlag) = _models()
    x0, U = (torch.from_numpy(a) for a in _inputs(rng, 5, 12))
    before = dict(_build.launches)
    fn = cr.make_rollout_final_cuda(tp, tcfg, tlag, 0.02, "rk4")
    got = fn(x0, U)
    assert torch.equal(got, cr.rollout_final_plain(tp, tcfg, tlag, x0, U, 0.02, "rk4"))
    assert torch.equal(cr.rollout_final_cuda(tp, tcfg, tlag, x0, U, 0.02), got)
    assert _build.launches == before  # no kernel counted on the CPU path


def test_kernel_constants_round_once_from_float64():
    tp = tparams.fossen_params(current=(0.3, -0.2, 0.1), device="cpu")
    k = cr.row_consts(tp, 0.02)
    added = tp.added.double().numpy()
    assert k.yz == np.float32(added[1] - added[2])
    assert k.WB == np.float32(float(tp.W) - float(tp.B))
    assert k.zbB == np.float32(float(tp.cb[2]) * float(tp.B))
    assert (k.dt, k.half_dt, k.sixth_dt) == (np.float32(0.02), np.float32(0.01),
                                             np.float32(0.02 / 6.0))
    assert list(k.cur) == [np.float32(v) for v in (0.3, -0.2, 0.1)]
    c = cr.thruster_consts(tparams.thruster_config(device="cpu"),
                           tparams.lag_params(0.02, device="cpu"))
    assert list(c.curve) == [np.float32(v) for v in tparams.T200_CURVE]
    assert len(c.Wm) == 48 and c.Wm[1] == tparams.thruster_config(device="cpu").wrench_map[0, 1]


def test_wrappers_reject_what_the_kernel_does_not_take(rng):
    _, (tp, tcfg, tlag) = _models()
    with pytest.raises(ValueError, match="unknown method"):
        cr.make_rollout_final_cuda(tp, tcfg, tlag, 0.02, "rk2")
    x0 = torch.zeros(4, 12)
    tau = torch.zeros(3, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cr.launch_rollout(cr.row_consts(tp, 0.02), tau, x0, "rk4")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cr.launch_tau_seq(cr.thruster_consts(tcfg, tlag), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cr.launch_rollout_from_commands(cr.row_consts(tp, 0.02), cr.thruster_consts(tcfg, tlag),
                                        torch.zeros(3, 8), x0, "rk4")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_kernel_matches_plain_on_card(method, cuda, rng):
    p, cfg, lag = (c.to(cuda) for c in _models(current=(0.1, 0.0, -0.05))[1])
    x0, U = (torch.from_numpy(a).to(cuda) for a in _inputs(rng, 1000, 50))
    before = _build.launches["rollout_final"]
    got = cr.make_rollout_final_cuda(p, cfg, lag, 0.02, method)(x0, U)
    torch.cuda.synchronize()
    assert _build.launches["rollout_final"] == before + 1
    want = cr.rollout_final_plain(p, cfg, lag, x0, U, 0.02, method)
    # FMA contraction in the kernel is the only difference
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("T", EDGE_T)
def test_kernel_at_edge_shapes_on_card(T, B, cuda, rng):
    p, cfg, lag = (c.to(cuda) for c in _models()[1])
    x0, U = (torch.from_numpy(a).to(cuda) for a in _inputs(rng, B, T))
    tau = cr.shared_tau_sequence(cfg, lag, U)
    before = _build.launches["rollout_final"]
    got = cr.launch_rollout(cr.row_consts(p, 0.02), tau, x0, "rk4")
    torch.cuda.synchronize()
    assert _build.launches["rollout_final"] == before + 1
    want = cr.rollout_rows_plain(p, tau, x0, 0.02, "rk4")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("use_lag", [True, False])
@pytest.mark.parametrize("T", (0,) + CHUNK_T)
def test_rollout_from_commands_matches_plain_on_card(T, use_lag, cuda, rng):
    """The main path's one C call: its tau_seq against the chunked plain
    version; its xT against the plain rollout (up to 500 steps) and against
    the K1 kernel stepped on the prologue kernel's own tau_seq."""
    p, cfg, lag = (c.to(cuda) for c in _models()[1])
    x0, U = (torch.from_numpy(a).to(cuda) for a in _inputs(rng, 300, T))
    rc, tc = cr.row_consts(p, 0.02), cr.thruster_consts(cfg, lag)
    tau = torch.full((T, 6), float("nan"), device=cuda)
    before = dict(_build.launches)
    got = cr.launch_rollout_from_commands(rc, tc, U, x0, "rk4", use_lag, tau=tau)
    torch.cuda.synchronize()
    assert _build.launches["rollout_final"] == before["rollout_final"] + 1
    assert _build.launches["shared_tau"] == before["shared_tau"]   # no prologue launch
    want_tau = cr.shared_tau_sequence_chunked(cfg, lag, U, use_lag)
    np.testing.assert_allclose(tau.cpu().numpy(), want_tau.cpu().numpy(), rtol=1e-5, atol=1e-4)
    two = cr.launch_rollout(rc, cr.launch_tau_seq(tc, U, use_lag), x0, "rk4")
    np.testing.assert_allclose(got.cpu().numpy(), two.cpu().numpy(), atol=2e-5)
    if T <= 500:
        want = cr.rollout_rows_plain(p, want_tau, x0, 0.02, "rk4")
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5)


@pytest.mark.cuda
def test_rollout_from_commands_is_one_launch_in_one_wave_on_card(cuda):
    """One kernel a call (the prologue folded into K1), 256 threads a block,
    three resident an SM as K1 on a ready tau_seq: 65,536 trajectories in
    one wave."""
    block, per_sm = cr.rollout_commands_occupancy("rk4")
    assert (block, per_sm) == cr.rollout_occupancy("rk4") == (256, 3)
    from bluerov2_dynamics_tpu_torch.eval.timing import profile_calls
    p, cfg, lag = (c.to(cuda) for c in _models()[1])
    fn = cr.make_rollout_final_cuda(p, cfg, lag, 0.02, "rk4")
    x0, U = torch.zeros((1000, 12), device=cuda), torch.zeros((300, 8), device=cuda)
    # every device event of one call; a profile that traced nothing on the
    # card is taken again, up to three times
    for _ in range(3):
        events, _ = profile_calls(lambda: fn(x0, U), calls=1)
        if events:
            break
    kernels = [e.name for e in events]
    assert len(kernels) == 1 and "rollout_commands_kernel" in kernels[0], kernels


# --- the kernels' constant structs ------------------------------------------------

def _per_field(t):
    return [float(v) for v in t.detach().cpu().reshape(-1).tolist()]


def _row_consts_per_field(p, dt):
    """The structs as the port built them before, one read-back a field."""
    added, (xb, yb, zb) = _per_field(p.added), _per_field(p.cb)
    W, Bf = float(p.W), float(p.B)
    k = cr.RowConsts()
    for name, t in (("mdiag", p.mdiag), ("minv", p.minv), ("gyro", p.gyro), ("d_lin", p.d_lin),
                    ("d_quad", p.d_quad), ("cur", p.current.expand(3))):
        getattr(k, name)[:] = _per_field(t)
    k.yz, k.zx, k.xy = added[1] - added[2], added[2] - added[0], added[0] - added[1]
    k.WB, k.xbB, k.ybB, k.zbB = W - Bf, xb * Bf, yb * Bf, zb * Bf
    k.dt, k.half_dt, k.sixth_dt = dt, 0.5 * dt, dt / 6.0
    return k


def _thruster_consts_per_field(cfg, lag):
    c = cr.ThrusterConsts()
    c.curve[:], c.Ad[:], c.Bd[:] = _per_field(cfg.curve), _per_field(lag.Ad), _per_field(lag.Bd)
    c.c[:], c.Wm[:] = _per_field(lag.c), _per_field(cfg.wrench_map)
    return c


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("current", [(0.0, 0.0, 0.0), (0.2, -0.15, 0.05)])
def test_constant_structs_are_read_back_in_one_copy(current, dtype, monkeypatch):
    """``row_consts`` and ``thruster_consts`` give the per-field reads'
    structs byte for byte, each from one ``.cpu()`` copy."""
    p = tparams.fossen_params(current=current, dtype=dtype, device="cpu")
    cfg = tparams.thruster_config(dtype=dtype, device="cpu")
    lag = tparams.lag_params(0.02, dtype=dtype, device="cpu")
    want_k, want_c = bytes(_row_consts_per_field(p, 0.02)), bytes(_thruster_consts_per_field(cfg, lag))
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **kw: copies.append(1) or cpu(t, *a, **kw))
    got_k = bytes(cr.row_consts(p, 0.02))
    assert len(copies) == 1
    got_c = bytes(cr.thruster_consts(cfg, lag))
    assert len(copies) == 2
    assert got_k == want_k and got_c == want_c

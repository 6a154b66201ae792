"""K2 (thruster sliding window), K3 (per-trajectory rollout) and K4
(wrench sliding window): their plain versions against the JAX package's
Pallas kernels in interpret mode (CPU), and the CUDA kernels against the
plain versions where a card exists.

Tolerances in float32: rtol 2e-4 / atol 2e-5 (``TOL``), the JAX package's
own for these kernels (tests/test_pallas_eval.py); atol 2e-5 alone
(``TOL_ROWS``) for the K3/K4 cases against the Pallas kernel and for K4
and K3's edge shapes on the card, where both sides do the same operations
in the same order on states of order one.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_eval as jpe
from bluerov2_dynamics_tpu_torch.models import fossen as tfossen
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce

TOL = dict(rtol=2e-4, atol=2e-5)
TOL_ROWS = dict(rtol=0.0, atol=2e-5)
CURRENTS = [(0.0, 0.0, 0.0), (0.2, -0.15, 0.05)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(dt=0.02):
    j = (jparams.fossen_params(dtype=jnp.float32), jparams.thruster_config(dtype=jnp.float32),
         jparams.lag_params(dt, dtype=jnp.float32))
    t = (tparams.fossen_params(device="cpu"), tparams.thruster_config(device="cpu"),
         tparams.lag_params(dt, device="cpu"))
    return j, t


def _data(rng, N=60, dt=0.02):
    """A short recording simulated by the JAX package, with sensor noise."""
    jp = jparams.fossen_params(dtype=jnp.float32)
    jcfg = jparams.thruster_config(dtype=jnp.float32)
    jlag = jparams.lag_params(dt, dtype=jnp.float32)
    U = np.clip(rng.normal(size=(N, 8)) * 0.4, -1, 1).astype(np.float32)
    x0 = jnp.zeros(12, jnp.float32).at[2].set(1.0)
    X = np.asarray(jfossen.simulate_thruster(jp, jcfg, jlag, x0, jnp.asarray(U), dt)[:-1])
    X = (X + rng.normal(size=X.shape) * 1e-3).astype(np.float32)
    port = (tparams.fossen_params(device="cpu"), tparams.thruster_config(device="cpu"),
            tparams.lag_params(dt, device="cpu"))
    return (jp, jcfg, jlag), port, X, U, dt


@pytest.mark.parametrize("H,method,use_lag", [(7, "euler", True), (10, "rk4", True),
                                              (5, "rk4", False)])
def test_plain_window_matches_pallas_interpret(H, method, use_lag, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag), X, U, dt = _data(rng)
    want = jpe.make_endpoint_final_pallas(jp, jcfg, jlag, dt, H, method=method,
                                          block_b=8, interpret=True,
                                          use_lag=use_lag)(jnp.asarray(X), jnp.asarray(U))
    got = ce.endpoint_final_plain(tp, tcfg, tlag, torch.from_numpy(X),
                                  torch.from_numpy(U), dt, H, method, use_lag)
    assert got.shape == (X.shape[0] - H, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_each_start_gets_a_fresh_lag(rng):
    """Every window equals a rollout of its own from at-rest filters."""
    _, (tp, tcfg, tlag), X, U, dt = _data(rng, N=30)
    H = 6
    got = ce.make_endpoint_final_cuda(tp, tcfg, tlag, dt, H, method="euler")(
        torch.from_numpy(X), torch.from_numpy(U))
    for k in range(X.shape[0] - H):
        traj = tfossen.simulate_thruster(tp, tcfg, tlag, torch.from_numpy(X[k]),
                                         torch.from_numpy(U[k:k + H]), dt, "euler")
        np.testing.assert_allclose(got[k].numpy(), traj[-1].numpy(), **TOL)


def test_rmse_through_the_wrapper_matches_jax(rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag), X, U, dt = _data(rng)
    H = 9
    want = float(jpe.endpoint_rmse_pallas(jp, jcfg, jlag, jnp.asarray(X), jnp.asarray(U),
                                          dt, H, method="euler", block_b=8,
                                          interpret=True))
    before = dict(_build.launches)
    got = float(ce.endpoint_rmse_cuda(tp, tcfg, tlag, torch.from_numpy(X),
                                      torch.from_numpy(U), dt, H, method="euler"))
    assert _build.launches == before  # CPU tensors: plain version, no kernel
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("bad", ["x_width", "u_width", "u_short", "horizon"])
def test_shape_mismatch_raises(bad, rng):
    _, (tp, tcfg, tlag), X, U, dt = _data(rng, N=20)
    X, U, H = torch.from_numpy(X), torch.from_numpy(U), 5
    X, U, H = {
        "x_width": (X[:, :11], U, H),
        "u_width": (X, torch.cat([U, U[:, :1]], dim=1), H),  # e.g. a 9-column U
        "u_short": (X, U[:-1], H),
        "horizon": (X, U, X.shape[0]),
    }[bad]
    fn = ce.make_endpoint_final_cuda(tp, tcfg, tlag, dt, H, method="euler")
    with pytest.raises(ValueError):
        fn(X, U)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_kernel_matches_plain_on_card(method, cuda, rng):
    _, port, X, U, dt = _data(rng, N=80)
    p, cfg, lag = (c.to(cuda) for c in port)
    X, U = torch.from_numpy(X).to(cuda), torch.from_numpy(U).to(cuda)
    before = _build.launches["window_eval"]
    got = ce.make_endpoint_final_cuda(p, cfg, lag, dt, 10, method=method)(X, U)
    torch.cuda.synchronize()
    assert _build.launches["window_eval"] == before + 1
    want = ce.endpoint_final_plain(p, cfg, lag, X, U, dt, 10, method)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


# --- K3: per-trajectory rollout --------------------------------------------------

def _batched_inputs(rng, B=12, T=25):
    x0 = (rng.normal(size=(B, 12)) * 0.3).astype(np.float32)
    U = np.clip(rng.normal(size=(T, B, 8)) * 0.5, -1, 1).astype(np.float32)
    return x0, U


@pytest.mark.parametrize("method,use_lag", [("rk4", True), ("euler", True), ("rk4", False)])
def test_plain_batched_rollout_matches_pallas_interpret(method, use_lag, rng):
    (jp, jcfg, jlag), (tp, tcfg, tlag), _, _, dt = _data(rng, N=20)
    x0, U = _batched_inputs(rng)
    want = jpe.make_batched_rollout_pallas(jp, jcfg, jlag, dt, method=method, block_b=8,
                                           interpret=True, use_lag=use_lag)(
        jnp.asarray(x0), jnp.asarray(U))
    got = ce.batched_rollout_plain(tp, tcfg, tlag, torch.from_numpy(x0), torch.from_numpy(U),
                                   dt, method, use_lag)
    assert got.shape == (12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_ROWS)


# the edges K3 masks: T below and across its two rows in flight, B across
# the block
EDGE_T, EDGE_B = (1, 3, 7), (1, 65, 130)
EDGE_RUNS = [("euler", True), ("rk4", True), ("euler", False), ("rk4", False)]
# the cases whose Pallas run at their own B differs in the last bits from the
# first rows of the run at the largest B (up to 3e-8, XLA's CPU code for
# another batch width): they keep a compile of their own
EDGE_OWN_RUN = {(1, 1, "euler", True), (1, 1, "rk4", True)}
_edge_runs = {}


def _edge_case(T, B, method, use_lag):
    """The inputs of the ``(T, B)`` edge case and the Pallas kernel's
    result on them, in interpret mode: one compile and run a ``(T, method,
    use_lag)`` at the largest B, whose first B rows a smaller B takes (the
    trajectories are independent), inputs drawn once a T."""
    own = (T, B, method, use_lag) in EDGE_OWN_RUN
    key = (T, B, method, use_lag) if own else (T, method, use_lag)
    if key not in _edge_runs:
        (jp, jcfg, jlag), _ = _params()
        x0, U = _batched_inputs(np.random.default_rng(0), B=max(EDGE_B), T=T)
        if own:
            x0, U = x0[:B], U[:, :B]
        want = jpe.make_batched_rollout_pallas(jp, jcfg, jlag, 0.02, method=method, block_b=64,
                                               interpret=True, use_lag=use_lag)(
            jnp.asarray(x0), jnp.asarray(U))
        _edge_runs[key] = x0, U, np.asarray(want)
    x0, U, want = _edge_runs[key]
    return x0[:B], np.ascontiguousarray(U[:, :B]), want[:B]


@pytest.mark.parametrize("method,use_lag", EDGE_RUNS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("T", EDGE_T)
def test_plain_batched_rollout_matches_pallas_at_edge_shapes(T, B, method, use_lag):
    _, (tp, tcfg, tlag) = _params()
    x0, U, want = _edge_case(T, B, method, use_lag)
    got = ce.batched_rollout_plain(tp, tcfg, tlag, torch.from_numpy(x0), torch.from_numpy(U),
                                   0.02, method, use_lag)
    assert got.shape == (B, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL_ROWS)


@pytest.mark.parametrize("B", (*EDGE_B, 300))
@pytest.mark.parametrize("T", EDGE_T)
def test_stage_plan_fits_and_covers_every_step_once(T, B):
    """Every (step, trajectory) is loaded exactly once, by 16-byte-aligned
    loads of 16 bytes, one step before the step that uses it, and nothing
    past B or T; the grid covers B and the plan takes no shared memory."""
    plan = ce.stage_plan(B, T)
    assert plan["shared_bytes"] == 0 and plan["depth"] == 2
    assert plan["n_blocks"] * plan["block"] >= B > (plan["n_blocks"] - 1) * plan["block"]
    loaded = {}
    for at, t, b, src, nbytes in ce.stage_loads(B, T):
        assert nbytes == 16 and src % 16 == 0 and 0 <= src < T * B * ce.ROW_BYTES
        assert src // ce.ROW_BYTES == t * B + b and 0 <= b < B
        assert at == max(0, t - 1)
        loaded[t, b] = loaded.get((t, b), 0) + nbytes
    assert loaded == {(t, b): ce.ROW_BYTES for t in range(T) for b in range(B)}


def test_stage_plan_keeps_the_bench_shape_in_one_wave_by_its_launch_bounds():
    """At 65,536 trajectories the launch bounds make every block resident
    at once on the H100's 132 SMs: the blocks one SM must hold fit its
    register file at the bounds' cap (ptxas spills rather than exceed it,
    and chip_smoke.py fails on a spill and on a second wave)."""
    plan = ce.stage_plan(65_536, 500)
    assert -(-plan["n_blocks"] // 132) <= ce.MIN_BLOCKS
    assert ce.MIN_BLOCKS * plan["block"] * plan["max_registers"] <= ce.REGISTERS
    assert plan["max_registers"] >= 128      # the row step needs about 100


def test_stage_plan_mirrors_the_kernel_constants():
    """``BLOCK`` and ``MIN_BLOCKS`` are the kernel's ``kBlock`` and
    ``kMinBlocks``."""
    src = (Path(ce.__file__).parent.parent / "csrc" / "batched_rollout.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (kBlock|kMinBlocks) = (\d+);", src)}
    assert got == {"kBlock": ce.BLOCK, "kMinBlocks": ce.MIN_BLOCKS}
    assert "__launch_bounds__(kBlock, kMinBlocks)" in src
    assert ce.stage_plan(10, 10) == dict(block=ce.BLOCK, depth=2, n_blocks=1, n_steps=10,
                                         max_registers=128, shared_bytes=0)


def test_batched_rollout_gives_each_trajectory_its_own_commands(rng):
    """Trajectory b equals a rollout of its own from at-rest filters, and
    the CPU path counts no launch."""
    _, (tp, tcfg, tlag), _, _, dt = _data(rng, N=20)
    x0, U = (torch.from_numpy(a) for a in _batched_inputs(rng, B=5, T=8))
    before = dict(_build.launches)
    got = ce.make_batched_rollout_cuda(tp, tcfg, tlag, dt, "rk4")(x0, U)
    assert _build.launches == before
    for b in range(5):
        traj = tfossen.simulate_thruster(tp, tcfg, tlag, x0[b], U[:, b], dt, "rk4")
        np.testing.assert_allclose(got[b].numpy(), traj[-1].numpy(), **TOL)


# --- K4: wrench-input sliding window ---------------------------------------------

def _wrench_data(rng, current, N=70, dt=0.02):
    """A wrench-input recording simulated by the JAX package, with sensor
    noise."""
    jp = jparams.fossen_params(current=current, dtype=jnp.float32)
    TAU = (rng.normal(size=(N, 6)) * 3.0).astype(np.float32)
    x0 = jnp.asarray(rng.normal(size=12) * 0.2, jnp.float32)
    X = np.asarray(jfossen.simulate_wrench(jp, x0, jnp.asarray(TAU), dt)[:-1])
    X = (X + rng.normal(size=X.shape) * 1e-3).astype(np.float32)
    return jp, tparams.fossen_params(current=current, device="cpu"), X, TAU, dt


@pytest.mark.parametrize("current", CURRENTS)
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_plain_wrench_window_matches_pallas_interpret(method, current, rng):
    jp, tp, X, TAU, dt = _wrench_data(rng, current)
    H = 10
    want = jpe.make_endpoint_final_pallas_wrench(jp, dt, H, method=method, block_b=16,
                                                 interpret=True)(jnp.asarray(X), jnp.asarray(TAU))
    got = ce.endpoint_final_wrench_plain(tp, torch.from_numpy(X), torch.from_numpy(TAU),
                                         dt, H, method)
    assert got.shape == (X.shape[0] - H, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_ROWS)


def test_wrench_window_rmse_matches_the_jax_step_loop(rng):
    jp, tp, X, TAU, dt = _wrench_data(rng, CURRENTS[1])
    H = 7
    before = dict(_build.launches)
    final = ce.make_endpoint_final_cuda_wrench(tp, dt, H, "euler")(
        torch.from_numpy(X), torch.from_numpy(TAU))
    assert _build.launches == before  # CPU tensors: plain version, no kernel
    got = float(torch.sqrt(torch.mean((torch.from_numpy(X[H:]) - final) ** 2)))
    step = jfossen.make_wrench_step(jp, dt, method="euler", state="euler12")
    want = float(jmetrics.endpoint_rmse(step, jnp.asarray(X), jnp.asarray(TAU), H))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("bad,match", [("thruster_cmds", "U must be"), ("short", "rows"),
                                       ("x_width", "X must be"), ("horizon", "horizon")])
def test_wrench_window_rejects_mis_shaped_inputs(bad, match):
    """The texts of the JAX window evaluator's assertions (pallas_eval.py:149-155)."""
    tp = tparams.fossen_params(device="cpu")
    X, TAU, H = torch.zeros(40, 12), torch.zeros(40, 6), 10
    X, TAU, H = {
        "thruster_cmds": (X, torch.zeros(40, 8), H),
        "short": (X, torch.zeros(20, 6), H),
        "x_width": (torch.zeros(40, 13), TAU, H),
        "horizon": (X, TAU, 40),
    }[bad]
    with pytest.raises(ValueError, match=match):
        ce.make_endpoint_final_cuda_wrench(tp, 0.02, H, "euler")(X, TAU)


def test_new_factories_reject_unknown_methods_and_shapes():
    tp, tcfg, tlag = (tparams.fossen_params(device="cpu"), tparams.thruster_config(device="cpu"),
                      tparams.lag_params(0.02, device="cpu"))
    for bad in ("rk2", "Euler"):
        with pytest.raises(ValueError, match="unknown method"):
            ce.make_endpoint_final_cuda_wrench(tp, 0.02, 10, bad)
        with pytest.raises(ValueError, match="unknown method"):
            ce.make_batched_rollout_cuda(tp, tcfg, tlag, 0.02, bad)
    fn = ce.make_batched_rollout_cuda(tp, tcfg, tlag, 0.02, "euler")
    with pytest.raises(ValueError, match="U must be"):
        fn(torch.zeros(4, 12), torch.zeros(3, 5, 8))       # B mismatch
    with pytest.raises(ValueError, match="x0 must be"):
        fn(torch.zeros(4, 13), torch.zeros(3, 4, 8))
    rc, tc = ce.row_consts(tp, 0.02), ce.thruster_consts(tcfg, tlag)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ce.launch_batched_rollout(rc, tc, torch.zeros(4, 12), torch.zeros(3, 4, 8), "rk4", True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ce.launch_window_eval_wrench(rc, torch.zeros(20, 12), torch.zeros(20, 6), 5, "euler")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_batched_rollout_kernel_matches_plain_on_card(method, cuda, rng):
    _, port, _, _, dt = _data(rng, N=20)
    p, cfg, lag = (c.to(cuda) for c in port)
    x0, U = (torch.from_numpy(a).to(cuda) for a in _batched_inputs(rng, B=1000, T=50))
    before = _build.launches["batched_rollout"]
    got = ce.make_batched_rollout_cuda(p, cfg, lag, dt, method)(x0, U)
    torch.cuda.synchronize()
    assert _build.launches["batched_rollout"] == before + 1
    want = ce.batched_rollout_plain(p, cfg, lag, x0, U, dt, method)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_wrench_window_kernel_matches_plain_on_card(method, cuda, rng):
    _, tp, X, TAU, dt = _wrench_data(rng, CURRENTS[1], N=300)
    p = tp.to(cuda)
    X, TAU = torch.from_numpy(X).to(cuda), torch.from_numpy(TAU).to(cuda)
    before = _build.launches["window_eval_wrench"]
    got = ce.make_endpoint_final_cuda_wrench(p, dt, 20, method)(X, TAU)
    torch.cuda.synchronize()
    assert _build.launches["window_eval_wrench"] == before + 1
    want = ce.endpoint_final_wrench_plain(p, X, TAU, dt, 20, method)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("method,use_lag", EDGE_RUNS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("T", EDGE_T)
def test_batched_rollout_kernel_at_edge_shapes_on_card(T, B, method, use_lag, cuda, rng):
    """The kernel at ragged B and T, below and across its two rows in
    flight."""
    p, cfg, lag = (c.to(cuda) for c in _params()[1])
    x0, U = (torch.from_numpy(a).to(cuda) for a in _batched_inputs(rng, B=B, T=T))
    rc, tc = ce.row_consts(p, 0.02), ce.thruster_consts(cfg, lag)
    want = ce.batched_rollout_plain(p, cfg, lag, x0, U, 0.02, method, use_lag)
    before = _build.launches["batched_rollout"]
    got = ce.launch_batched_rollout(rc, tc, x0, U, method, use_lag)
    torch.cuda.synchronize()
    assert _build.launches["batched_rollout"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL_ROWS)


@pytest.mark.cuda
def test_batched_rollout_rejects_a_misaligned_U_on_card(cuda):
    p, cfg, lag = (c.to(cuda) for c in _params()[1])
    fn = ce.make_batched_rollout_cuda(p, cfg, lag, 0.02, "rk4")
    buf = torch.zeros(3 * 5 * 8 + 1, device=cuda)
    U = buf[1:].view(3, 5, 8)             # contiguous, 4 bytes off a 16-byte boundary
    before = _build.launches["batched_rollout"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(torch.zeros(5, 12, device=cuda), U)
    assert _build.launches["batched_rollout"] == before

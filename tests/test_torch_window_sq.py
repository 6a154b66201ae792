"""The fused window evaluators (K2, K4 and K5 reducing the squared endpoint
error in the kernel) and the window kernels' launch plans.

On the CPU: the plain fused sums (``window_sq_plain*``: the endpoints, then
``torch.sum(d * d)`` in float32) against the JAX package's Pallas window
kernels in interpret mode followed by ``jnp.sum(d * d)`` in explicit
float32, at rtol 1e-6; the launch plans (K2: every start run by exactly
one thread; K4: by exactly one warp pair up to its split threshold and
one thread above it; K5: one thread; each plan mirroring its kernel's
constants); the
apps' evaluator policy taking the fused factories.  Where a card exists:
each fused kernel against its plain version at rtol 1e-5 (a float32 sum
reordered, ``csrc/fossen_rows.cuh`` ``grid_sum``), K2 at ragged start
counts at ``TOL`` (rtol 2e-4, atol 2e-5, the JAX package's own), K4 and K5
at ragged start counts and both sides of K4's threshold at atol 2e-5,
the same bits on every call, the plans
the launchers report equal to the mirrors, and a misaligned ``U`` refused.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_eval as jpe
from bluerov2_dynamics_tpu.ops import pallas_quat as jpq
from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq

DT = 0.02
TOL = dict(rtol=2e-4, atol=2e-5)
KINDS = ["thruster", "thruster_no_lag", "wrench", "quat"]
CSRC = Path(ce.__file__).resolve().parent.parent / "csrc"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, kind, N):
    """``(X, input)`` float32 arrays of one input contract."""
    n_state = 13 if kind == "quat" else 12
    X = rng.normal(size=(N, n_state)) * 0.1
    if kind == "quat":
        X[:, 3] += 1.0                                  # near-identity quaternions
    if kind.startswith("thruster"):
        V = np.clip(rng.normal(size=(N, 8)) * 0.4, -1, 1)
    else:
        V = rng.normal(size=(N, 6)) * 4.0
    return X.astype(np.float32), V.astype(np.float32)


def _jax_sq(kind, method, H, X, V):
    """The JAX package's endpoints (Pallas, interpret mode), then the
    per-shard body's ``jnp.sum(d * d)`` in float32."""
    p = jparams.fossen_params(dtype=jnp.float32)
    if kind.startswith("thruster"):
        fn = jpe.make_endpoint_final_pallas(
            p, jparams.thruster_config(dtype=jnp.float32), jparams.lag_params(DT, dtype=jnp.float32),
            DT, H, method=method, block_b=8, interpret=True, use_lag=kind == "thruster")
    elif kind == "wrench":
        fn = jpe.make_endpoint_final_pallas_wrench(p, DT, H, method=method, block_b=8,
                                                  interpret=True)
    else:
        fn = jpq.make_endpoint_final_pallas_quat(p, DT, H, method=method, block_b=8,
                                                 interpret=True)
    X32 = jnp.asarray(X, jnp.float32)
    d = fn(X32, jnp.asarray(V, jnp.float32)) - X32[H:]
    return float(jnp.sum(d * d, dtype=jnp.float32))


def _port(device="cpu"):
    return (tparams.fossen_params(device=device), tparams.thruster_config(device=device),
            tparams.lag_params(DT, device=device))


def _sq_factory(kind, method, H, device="cpu"):
    p, cfg, lag = _port(device)
    if kind.startswith("thruster"):
        return ce.make_endpoint_sq_cuda(p, cfg, lag, DT, H, method, use_lag=kind == "thruster")
    if kind == "wrench":
        return ce.make_endpoint_sq_cuda_wrench(p, DT, H, method)
    return cq.make_endpoint_sq_cuda_quat(p, DT, H, method)


def _sq_plain(kind, method, H, X, V, device="cpu"):
    p, cfg, lag = _port(device)
    if kind.startswith("thruster"):
        return ce.window_sq_plain(p, cfg, lag, X, V, DT, H, method, use_lag=kind == "thruster")
    if kind == "wrench":
        return ce.window_sq_wrench_plain(p, X, V, DT, H, method)
    return cq.window_sq_quat_plain(p, X, V, DT, H, method)


# --- CPU: the plain fused sums against the JAX package ------------------------

@pytest.mark.parametrize("H", [1, 7])
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_fused_sum_matches_pallas_interpret(kind, method, H, rng):
    X, V = _inputs(rng, kind, N=24)
    want = _jax_sq(kind, method, H, X, V)
    before = dict(_build.launches)
    got = _sq_factory(kind, method, H)(torch.from_numpy(X), torch.from_numpy(V))
    assert _build.launches == before              # CPU tensors: the plain version
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_plain_fused_sum_is_the_endpoints_squared_error(rng):
    """``window_sq_plain`` is ``sum |endpoint_final_plain - X[H:]|^2``."""
    X, U = (torch.from_numpy(a) for a in _inputs(rng, "thruster", N=30))
    p, cfg, lag = _port()
    final = ce.endpoint_final_plain(p, cfg, lag, X, U, DT, 5, "euler")
    want = float(((final.double() - X[5:].double()) ** 2).sum())
    np.testing.assert_allclose(float(ce.window_sq_plain(p, cfg, lag, X, U, DT, 5, "euler")),
                               want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_fused_factories_check_shapes_on_the_cpu(kind):
    fn = _sq_factory(kind, "euler", 10)
    X, V = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(1), kind, N=20))
    with pytest.raises(ValueError, match="horizon"):
        _sq_factory(kind, "euler", 20)(X, V)
    with pytest.raises(ValueError, match="must be"):
        fn(X[:, :-1], V)
    with pytest.raises(ValueError, match="unknown method"):
        _sq_factory(kind, "rk2", 10)


# --- the window kernels' launch plan ------------------------------------------------

@pytest.mark.parametrize("n_start", [1, 31, 33, 9_065, 44_800])
def test_window_plan_runs_every_start_on_exactly_one_thread(n_start):
    """By the kernels' index arithmetic (``own = blockIdx.x * blockDim.x +
    threadIdx.x``) each start is run by one thread; a thread past the end
    shadows the last start and is not live; the grid has no block without
    a live start."""
    plan = ce.window_plan(n_start, 100)
    assert plan["lanes"] == 1 and plan["n_steps"] == 100
    own = np.arange(plan["n_blocks"] * plan["block"])
    live = own < n_start
    s = np.where(live, own, n_start - 1)
    assert sorted(s[live]) == list(range(n_start))
    assert (own[~live] >= (plan["n_blocks"] - 1) * plan["block"]).all()
    assert (plan["n_blocks"] - 1) * plan["block"] < n_start


def _consts(name):
    """The ``constexpr int`` and ``bool`` constants of a ``csrc/`` source."""
    src = (CSRC / name).read_text()
    out = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    out.update({k: v == "true" for k, v in
                re.findall(r"constexpr bool (k\w+) = (true|false);", src)})
    return out


def test_window_plan_mirrors_the_kernel_constants():
    """``WINDOW_THREADS`` is ``csrc/window_eval.cu``'s ``kThreads`` (K2, and
    K4's one-thread form) and ``csrc/quat.cu``'s ``kWindowThreads`` (K5's
    one-thread form); ``WRENCH_CONSTS`` and ``QUAT_CONSTS`` are K4's and
    K5's warp-pair constants."""
    assert _consts("window_eval.cu")["kThreads"] == ce.WINDOW_THREADS
    assert _consts("quat.cu")["kWindowThreads"] == ce.WINDOW_THREADS
    assert ce.window_plan(9_065, 100)["block"] == ce.WINDOW_THREADS
    c = _consts("window_eval.cu")
    assert ce.WRENCH_CONSTS == ce.WindowConsts(
        threads=c["kThreads"], tau_chunk=c["kWrenchTauChunk"], pairs=c["kWrenchPairs"],
        split_starts_per_sm=c["kWrenchSplitStartsPerSm"])
    # a named barrier a pair (ids 1..15; 0 is __syncthreads's)
    assert 1 <= ce.WRENCH_CONSTS.pairs <= 15
    c = _consts("quat.cu")
    assert cq.QUAT_CONSTS == ce.WindowConsts(threads=c["kWindowThreads"],
                                             tau_chunk=c["kWindowTauChunk"])
    assert not any(k.startswith("kQuatPairs") for k in c)      # K5 has no pair form


PLANS = [("wrench", ce.wrench_plan), ("quat", cq.quat_plan)]


def _threshold(kind, sms):
    return (ce.WRENCH_CONSTS if kind == "wrench" else cq.QUAT_CONSTS).split_threshold(sms)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_start", [1, 31, 33, 64, 65, 9_065, 44_800, "at", "past"])
@pytest.mark.parametrize("kind,plan_of", PLANS)
def test_k4_k5_plans_run_every_start_on_exactly_one_warp_pair_or_thread(kind, plan_of, n_start,
                                                                       sms):
    """By the kernels' index arithmetic each start is run by one lane of
    both warps of one pair (``start = (block * pairs + pair) * 32 +
    lane``) or by one thread (``start = block * threads + thread``); lanes
    past the end shadow the last start; no block lacks a live start.
    ``at`` and ``past`` are K4's split threshold and one above it."""
    consts = ce.WRENCH_CONSTS if kind == "wrench" else cq.QUAT_CONSTS
    threshold = consts.split_threshold(sms)
    n_start = {"at": threshold, "past": threshold + 1}.get(n_start, n_start)
    if n_start < 1:
        pytest.skip("K5 has no pair form, so no threshold")
    plan = plan_of(n_start, 100, sms)
    assert plan["warps"] == (2 if n_start <= threshold else 1) and plan["n_steps"] == 100
    assert plan["block"] == plan["warps"] * plan["starts_per_block"]
    if plan["warps"] == 2:
        assert plan["starts_per_block"] == 32 * consts.pairs
        b, j, lane = np.meshgrid(np.arange(plan["n_blocks"]), np.arange(consts.pairs),
                                 np.arange(32), indexing="ij")
        own = ((b * consts.pairs + j) * 32 + lane).ravel()
    else:
        assert plan["starts_per_block"] == consts.threads
        own = np.arange(plan["n_blocks"] * plan["block"])
    live = own < n_start
    assert sorted(own[live]) == list(range(n_start))
    assert (plan["n_blocks"] - 1) * plan["starts_per_block"] < n_start
    assert (np.where(live, own, n_start - 1) < n_start).all()


def test_k4_plan_switches_at_the_threshold_and_k5_never_splits():
    """K4: two warps a start up to ``split_starts_per_sm`` starts an SM (the
    shared bytes are the pairs' exchange buffers), one above (the staged
    TAU rows); the fused wrappers size their partials by the plan's grid.
    K5: one thread a start at every count."""
    c = ce.WRENCH_CONSTS
    staged = (c.threads + c.tau_chunk - 1) * 24
    for sms in (1, 132):
        t = c.split_threshold(sms)
        at, past = ce.wrench_plan(t, 100, sms), ce.wrench_plan(t + 1, 100, sms)
        assert (at["warps"], past["warps"]) == (2, 1)
        assert at["block"] == 64 * c.pairs and past["block"] == c.threads
        assert at["n_blocks"] == -(-t // (32 * c.pairs))
        assert past["n_blocks"] == -(-(t + 1) // c.threads)
        assert at["shared_bytes"] == c.pairs * 4096 and past["shared_bytes"] == staged
    assert ce.wrench_plan(9_065, 100, 132)["warps"] == 2       # the apps' shape
    assert ce.wrench_plan(44_800, 100, 132)["warps"] == 1      # the full recording's
    for n in (1, 9_065, 44_800):
        plan = cq.quat_plan(n, 100, 132)
        assert (plan["warps"], plan["block"]) == (1, cq.QUAT_CONSTS.threads)
        assert plan["shared_bytes"] == (cq.QUAT_CONSTS.threads + cq.QUAT_CONSTS.tau_chunk - 1) * 24


# --- the apps' evaluator policy -----------------------------------------------------

@pytest.mark.parametrize("H", [1, 7])
@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_evaluator_rmse_is_the_root_of_the_fused_sum(kind, H, rng):
    """The kernel branch of ``endpoint_evaluator_with_kernel``
    (``common.fused_rmse``) returns ``sqrt(window_sq_plain / (n_start
    n))`` from the fused factories (CPU tensors take the plain fused sum);
    on the CPU the policy takes ``scan_eval``."""
    X, V = (torch.from_numpy(a) for a in _inputs(rng, kind, N=30))
    n_start, n = X.shape[0] - H, X.shape[1]
    want = torch.sqrt(_sq_plain(kind, "euler", H, X, V) / (n_start * n))
    got = common.fused_rmse(_sq_factory(kind, "euler", H), X, V, H)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want)
    run = common.endpoint_evaluator_with_kernel(
        X, V, build_kernel=lambda h: pytest.fail("the CPU policy takes scan_eval"),
        scan_eval=lambda h: torch.tensor(-1.0))
    assert float(run(H)) == -1.0 and np.isnan(float(run(X.shape[0])))


# --- on the card --------------------------------------------------------------------

def _card_inputs(rng, kind, N, cuda):
    return tuple(torch.from_numpy(a).to(cuda) for a in _inputs(rng, kind, N))


SQ_COUNTER = {"thruster": "window_sq", "thruster_no_lag": "window_sq",
              "wrench": "window_sq_wrench", "quat": "window_sq_quat"}


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_kernel_matches_plain_on_card(kind, method, cuda, rng):
    X, V = _card_inputs(rng, kind, 400, cuda)
    before = _build.launches[SQ_COUNTER[kind]]
    got = _sq_factory(kind, method, 30, cuda)(X, V)
    torch.cuda.synchronize()
    assert _build.launches[SQ_COUNTER[kind]] == before + 1
    assert got.shape == () and got.dtype == torch.float32 and got.is_cuda
    np.testing.assert_allclose(float(got), float(_sq_plain(kind, method, 30, X, V, cuda)),
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_start", [1, 33, 9_065])
def test_k2_at_ragged_starts_on_card(n_start, cuda, rng):
    """Endpoints and fused sum of K2, Euler with the lag, where the last
    block is partly past the end."""
    H = 10
    X, U = _card_inputs(rng, "thruster", n_start + H, cuda)
    p, cfg, lag = _port(cuda)
    rc, tc = ce.row_consts(p, DT), ce.thruster_consts(cfg, lag)
    want = ce.endpoint_final_plain(p, cfg, lag, X, U, DT, H, "euler")
    got = ce.launch_window_eval(rc, tc, X, U, H, "euler", True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    sq = ce.launch_window_sq(rc, tc, X, U, H, "euler", True)
    np.testing.assert_allclose(float(sq), float(ce.endpoint_sq(want, X, H)), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_fused_kernel_gives_the_same_bits_on_every_call(kind, cuda, rng):
    X, V = _card_inputs(rng, kind, 3000, cuda)
    fn = _sq_factory(kind, "euler", 100, cuda)
    bits = {fn(X, V).cpu().numpy().tobytes() for _ in range(10)}
    assert len(bits) == 1


def _pair_starts(kind, cuda):
    t = _threshold(kind, ce.sm_count(cuda))
    return {"at": t, "past": t + 1}


PAIR_RUNS = [("wrench", True), ("quat", True), ("quat", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 10, 100])
@pytest.mark.parametrize("n_start", [1, 31, 33, 64, 65, 9_065, "at", "past"])
@pytest.mark.parametrize("kind,renormalize", PAIR_RUNS)
def test_k4_k5_at_ragged_starts_on_card(kind, renormalize, n_start, H, cuda, rng):
    """K4 and K5, endpoints (atol 2e-5: states of order one, FMA
    contraction the only difference) and fused sum, Euler and RK4 (K5 with
    and without the renormalise), where a pair or block is partly past the
    end and on both sides of the split threshold (``at``, ``past``)."""
    n_start = _pair_starts(kind, cuda).get(n_start, n_start)
    if n_start < 1:
        pytest.skip("K5 has no pair form, so no threshold")
    X, V = _card_inputs(rng, kind, n_start + H, cuda)
    p = _port(cuda)[0]
    rc = ce.row_consts(p, DT)
    for method in ("euler", "rk4"):
        if kind == "wrench":
            want = ce.endpoint_final_wrench_plain(p, X, V, DT, H, method)
            got = ce.launch_window_eval_wrench(rc, X, V, H, method)
            sq = lambda: ce.launch_window_sq_wrench(rc, X, V, H, method)
        else:
            want = cq.endpoint_final_quat_plain(p, X, V, DT, H, method, renormalize)
            got = cq.launch_window_eval_quat(rc, X, V, H, method, renormalize)
            sq = lambda: cq.launch_window_sq_quat(rc, X, V, H, method, renormalize)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=2e-5)
        sums = [sq() for _ in range(3)]
        np.testing.assert_allclose(float(sums[0]), float(ce.endpoint_sq(want, X, H)), rtol=1e-5)
        assert len({t.cpu().numpy().tobytes() for t in sums}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["wrench", "quat"])
def test_k4_k5_plans_are_the_kernels_plans_on_card(kind, fused, cuda):
    """The plan K4's and K5's launchers report (warps, block, grid, static
    shared bytes) is the mirror's, and the kernel it picks is resident;
    the fused form adds only ``grid_sum``'s words."""
    sms = ce.sm_count(cuda)
    starts = _pair_starts(kind, cuda)
    for n in (1, 65, 9_065, 44_800, starts["at"], starts["past"]):
        if n < 1:
            continue
        if kind == "wrench":
            got, want = ce.wrench_occupancy(n, "euler", fused), ce.wrench_plan(n, 100, sms)
        else:
            got, want = cq.quat_occupancy(n, "euler", True, fused), cq.quat_plan(n, 100, sms)
        for k in ("warps", "block", "n_blocks"):
            assert got[k] == want[k], (n, k)
        assert got["blocks_per_sm"] >= 1
        extra = got["shared_bytes"] - want["shared_bytes"]
        assert extra == 0 if not fused else 0 <= extra <= 16 * (want["block"] // 32) + 16


@pytest.mark.cuda
def test_window_plan_is_the_kernels_plan_on_card(cuda):
    for fused in (False, True):
        occ = ce.window_occupancy(fused=fused)
        assert occ["block"] == ce.window_plan(9_065, 100)["block"]
        assert occ["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_fused_k2_rejects_a_misaligned_U_on_card(cuda):
    p, cfg, lag = _port(cuda)
    fn = ce.make_endpoint_sq_cuda(p, cfg, lag, DT, 5, "euler")
    U = torch.zeros(41 * 8, device=cuda)[1:1 + 40 * 8].view(40, 8)
    before = _build.launches["window_sq"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(torch.zeros(40, 12, device=cuda), U)
    assert _build.launches["window_sq"] == before

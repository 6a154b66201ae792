"""The port's ``parallel/`` (K7 and the sharded step loops) against the JAX
package's ``shard_map`` and GSPMD functions.

The port runs on 4 CPU ranks of a gloo group (``parallel.launch.run_ranks``;
one spawn for every 4-rank check, in the ``four_ranks`` fixture), the JAX
package on 4 devices of its conftest's virtual CPU mesh.  World-1 cases run
in this process on a one-rank ``HashStore`` group that is torn down at the
end of the module.  Inputs are made with numpy from a seed
(``torch_rank_checks.inputs``).

Tolerances: rtol 1e-5 for the float32 window evaluators (the dry run's,
``__graft_entry__.py:298-351``); rtol 1e-9 and atol 1e-10 for the float64
step loops (``tests/test_parallel.py:32-66``) and for the float64 sharded
Koopman functions, held against the JAX package's single-device
``multistep_rmse``, fit solve and ``streaming_scan``.  Data-parallel PINc
training (float32, 12 Adam steps, fed the JAX package's initial
parameters and draws): the loss history at rtol 1e-5 against
``pinc.train`` and against the port's single-device run (measured 8.2e-8
for both), the parameters at rtol 1e-5, atol 1e-6 against the
single-device run (measured 6.0e-8 abs): the gradients' mean over ranks
reorders float32 sums.  The Fossen identification (float32, 6 Adam
steps) over 4 ranks and on a one-rank group against the single-device
fit at the JAX test's tolerances (``tests/test_sysid.py``): losses at rtol
2e-4, log-scales, gains and current at rtol 1e-3 and atol 1e-5, and the
Laplace stderrs with the same ``inf`` entries and the finite ones at rtol
1e-3.  MPPI with its sample axis over 4 ranks (64 and 60 samples) against
the one-process run at the float64 step loops' tolerance, and bit for bit
at world 1.
"""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import torch_rank_checks as trc
from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import koopman as jk
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_eval as jpe
from bluerov2_dynamics_tpu.ops import lifting as jlift
from bluerov2_dynamics_tpu.ops import pallas_quat as jpq
from bluerov2_dynamics_tpu.parallel import mesh as jmesh
from bluerov2_dynamics_tpu.parallel import sharded as jsharded
from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.models import koopman as tk
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
from bluerov2_dynamics_tpu_torch.parallel import launch
from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh
from bluerov2_dynamics_tpu_torch.parallel import sharded

DT, H = trc.DT, trc.H_WINDOW
TOL32 = dict(rtol=1e-5)
TOL64 = dict(rtol=1e-9, atol=1e-10)


@pytest.fixture(scope="module")
def data():
    return trc.inputs()


@pytest.fixture(scope="module")
def pinc_inputs(tmp_path_factory):
    """The JAX package's PINc training inputs and results
    (``test_torch_pinc.jax_training``), and an .npz of them for the ranks."""
    from test_torch_pinc import jax_training

    d = jax_training()
    path = tmp_path_factory.mktemp("pinc") / "inputs.npz"
    np.savez(path, **d)
    return d, path


@pytest.fixture(scope="module")
def four_ranks(pinc_inputs):
    """Every port-side value of the 4-rank checks, one dict per rank."""
    os.environ[trc.PINC_INPUTS] = str(pinc_inputs[1])
    try:
        return launch.run_ranks(trc.all_checks, trc.WORLD, backend="gloo", timeout=120)
    finally:
        del os.environ[trc.PINC_INPUTS]


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(shape=(trc.WORLD,), axis_names=("data",),
                           devices=jax.devices()[:trc.WORLD])


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group in this process, torn down at module end."""
    pmesh.init_group("gloo")
    try:
        yield pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _j(a):
    return jnp.asarray(a)


def _jax_window(kind, mesh, d):
    """K7 of the JAX package, ``_shardmap_window_rmse``, with the kernel and
    scratch each of its wrappers (``sharded.py:194-287``) gives it, under
    one ``jax.jit``: run eagerly, its shard_map compiles every primitive on
    its own.  The kernel factories read the coefficients as constants, so
    they run before the trace."""
    from jax.experimental.pallas import tpu as pltpu

    p = jparams.fossen_params(dtype=jnp.float32)
    vmem = lambda *shape: pltpu.VMEM(shape, jnp.float32)  # noqa: E731
    if kind == "thruster":
        kernel = jpe._make_thruster_window_kernel(
            p, jparams.thruster_config(dtype=jnp.float32),
            jparams.lag_params(DT, dtype=jnp.float32), DT, "rk4", True)
        n_state, n_in, scratch = 12, 8, lambda b: [vmem(12, b), vmem(3, 8, b)]
        X, U = d["X12"], d["U8"]
    elif kind == "wrench":
        kernel = jpe._make_wrench_window_kernel(p, DT, "rk4")
        n_state, n_in, scratch = 12, 6, lambda b: [vmem(12, b)]
        X, U = d["X12"], d["TAU6"]
    else:
        kernel = jpq._make_quat_window_kernel(p, DT, "euler", True)
        n_state, n_in, scratch = 13, 6, lambda b: [vmem(13, b)]
        X, U = d["X13"], d["TAU6"]
    run = jax.jit(lambda X, U: jsharded._shardmap_window_rmse(
        mesh, kernel, n_state, n_in, scratch, X, U, H, 16, True, "data"))
    return run(_j(X), _j(U))


# --- 4 ranks against the JAX package's 4-device mesh --------------------------

@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_sharded_window_evaluators_match_jax_shard_map(kind, four_ranks, jax_mesh, data):
    want = float(_jax_window(kind, jax_mesh, data))
    got = [r[f"k7_{kind}"] for r in four_ranks]
    assert np.isfinite(want) and len(set(got)) == 1  # one value on every rank
    np.testing.assert_allclose(got[0], want, **TOL32)


def test_sharded_window_evaluators_on_cpu_launch_no_kernel(four_ranks):
    assert not any(r["k7_launched"] for r in four_ranks)
    assert [r["rank"] for r in four_ranks] == [(k, trc.WORLD) for k in range(trc.WORLD)]


@pytest.mark.parametrize("H_lin", [4, 9])
def test_sharded_endpoint_rmse_uneven_blocks_match_jax(H_lin, four_ranks, jax_mesh, data):
    """120 rows: 116 starts split 29 x 4 at H=4, 111 split 28/28/28/27 at H=9."""
    step = lambda x, u: x @ _j(data["A"]) + u @ _j(data["B"])  # noqa: E731
    X, U = _j(data["X_lin"]), _j(data["U_lin"])
    want = float(jsharded.sharded_endpoint_rmse(jax_mesh, step, X, U, H_lin))
    np.testing.assert_allclose(want, float(jmetrics.endpoint_rmse(step, X, U, H_lin)), **TOL64)
    for r in four_ranks:
        np.testing.assert_allclose(r[f"lin_sharded_H{H_lin}"], want, **TOL64)


def test_shardmap_endpoint_rmse_matches_jax(four_ranks, jax_mesh, data):
    step = lambda x, u: x @ _j(data["A"]) + u @ _j(data["B"])  # noqa: E731
    X, U = _j(data["X_div"]), _j(data["U_div"])
    want = float(jsharded.shardmap_endpoint_rmse(jax_mesh, step, X, U, 8))
    np.testing.assert_allclose(want, float(jmetrics.endpoint_rmse(step, X, U, 8)), **TOL64)
    for r in four_ranks:
        np.testing.assert_allclose(r["lin_shardmap"], want, **TOL64)


@pytest.mark.parametrize("B", [64, 62])
def test_sharded_fossen_rollout_matches_jax(B, four_ranks, jax_mesh, data):
    """The float64 Fossen wrench RK4 step, 25 steps.  62 rows split
    16/16/15/15, which the JAX function's input sharding refuses: there
    the reference is the single-device step loop alone."""
    step = jfossen.make_wrench_step(jparams.fossen_params(dtype=jnp.float64), DT, method="rk4")
    x0, TAU = _j(data["x0"][:B]), _j(data["TAU_roll"])
    want = np.asarray(jax.jit(lambda x, T: jax.lax.scan(
        lambda c, u: (step(c, u), None), x, T)[0])(x0, TAU))
    if B % trc.WORLD == 0:
        np.testing.assert_allclose(
            np.asarray(jsharded.sharded_rollout_final(jax_mesh, step, x0, TAU, 25)), want,
            **TOL64)
    key = "fossen_rollout" if B == 64 else "fossen_rollout_uneven"
    for r in four_ranks:
        assert r[key].shape == (B, 12)
        np.testing.assert_allclose(r[key], want, **TOL64)


@pytest.mark.parametrize("form", ["shardmap", "sharded_uneven"])
def test_fossen_endpoint_rmse_matches_jax(form, four_ranks, jax_mesh, data):
    step = jfossen.make_wrench_step(jparams.fossen_params(dtype=jnp.float64), DT, method="rk4")
    cut = 0 if form == "shardmap" else 2
    n = data["X_fossen"].shape[0] - cut
    X, TAU = _j(data["X_fossen"][:n]), _j(data["TAU_fossen"][:n])
    fn = jsharded.shardmap_endpoint_rmse if cut == 0 else jsharded.sharded_endpoint_rmse
    want = float(fn(jax_mesh, step, X, TAU, trc.H_FOSSEN))
    np.testing.assert_allclose(want, float(jmetrics.endpoint_rmse(step, X, TAU, trc.H_FOSSEN)),
                               **TOL64)
    for r in four_ranks:
        np.testing.assert_allclose(r[f"fossen_{form}"], want, **TOL64)


def test_contracts_match_jax(four_ranks, jax_mesh, data):
    """A ValueError, with the JAX text, where n_start does not divide by the
    axis; NaN where there is no start."""
    step = lambda x, u: x @ _j(data["A"]) + u @ _j(data["B"])  # noqa: E731
    with pytest.raises(ValueError) as jerr:
        jsharded.shardmap_endpoint_rmse(jax_mesh, step, _j(data["X_div"]), _j(data["U_div"]), 7)
    with pytest.raises(ValueError) as jerr_quat:
        jsharded.shardmap_endpoint_rmse_pallas_quat(
            jax_mesh, jparams.fossen_params(dtype=jnp.float32), _j(data["X13"][:-1]),
            _j(data["TAU6"][:-1]), DT, H, block_b=16, interpret=True)
    assert np.isnan(float(jsharded.shardmap_endpoint_rmse(
        jax_mesh, step, _j(data["X_div"]), _j(data["U_div"]), 104)))
    for r in four_ranks:
        assert r["lin_indivisible"] == str(jerr.value)
        assert r["k7_indivisible"] == str(jerr_quat.value)
        assert np.isnan(r["k7_nan"]) and all(np.isnan(v) for v in r["lin_nan"])


def test_make_mesh_2d_layout_and_shard_along_match_jax(four_ranks):
    jm = jmesh.make_mesh(shape=(2, 2), axis_names=("data", "model"),
                         devices=jax.devices()[:trc.WORLD])
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    x = jnp.arange(10.0)
    blocks = {}
    for name in ("data", "model"):
        arr = jmesh.shard_along(jm, x, name)
        blocks[name] = {s.device.id: np.asarray(s.data).tolist() for s in arr.addressable_shards}
    for rank, r in enumerate(four_ranks):
        assert r["mesh2d"] == ids.tolist()
        assert tuple(int(v) for v in np.argwhere(ids == rank)[0]) == tuple(r["mesh2d_coord"])
        assert r["shard_data"] == blocks["data"][rank]
        assert r["shard_model"] == blocks["model"][rank]


def test_replicate_broadcasts_the_first_rank_and_leaves_the_input(four_ranks):
    for rank, r in enumerate(four_ranks):
        assert r["replicated"] == ([0.0] * 3, [0, 0], [float(rank)] * 3)


def test_make_mesh_rejects_a_shape_that_misses_the_world(four_ranks):
    assert all(r["mesh_bad_shape"] == "mesh shape (3,) does not cover 4 ranks"
               for r in four_ranks)


def _jax_koopman_model(d):
    return jk.KoopmanModel(centers=_j(d["koop_C"]), gamma=jnp.asarray(trc.KOOP_GAMMA),
                           A=_j(d["koop_A"]), B=_j(d["koop_B"]))


@pytest.mark.parametrize("method", ["scan", "conv"])
def test_sharded_koopman_multistep_rmse_matches_jax(method, four_ranks, data):
    """2 x 2 mesh: 89 starts over 'data', A's 15 rows 8/7 over 'model'."""
    model = _jax_koopman_model(data)
    X, U = _j(data["koop_X"]), _j(data["koop_U"])
    for H in (0, 1, trc.KOOP_H):
        want = float(jk.multistep_rmse(model, X, U, H, method=method))
        for r in four_ranks:
            np.testing.assert_allclose(r[f"koop_ms_{method}_H{H}"], want, **TOL64)
    assert all(np.isnan(r[f"koop_ms_{method}_nan"]) for r in four_ranks)


@pytest.mark.parametrize("pi", [False, True])
def test_sharded_koopman_fit_matches_jax(pi, four_ranks, data):
    """Pairs split 24/24/24/23 over 'data'; the JAX fit's solve on the same
    centers (and its decoder without the position mask)."""
    X, U = _j(data["koop_X"]), _j(data["koop_U"])
    w = jnp.asarray([0.0, 0.0, 0.0, 1.0]) if pi else None
    C = _j(data["koop_C"]) * (w if pi else 1.0)
    lift = lambda Z: jlift.rbf_lift(Z, C, trc.KOOP_GAMMA, w)  # noqa: E731
    want = jk._fit_from_blocks(lift(X[:-1]), lift(X[1:]), U[:-1], C, trc.KOOP_GAMMA,
                               trc.KOOP_RIDGE)._replace(rbf_weights=w)
    if not pi:
        want = jk.fit_decoder(want, X)
    for r in four_ranks:
        got = r[f"koop_fit_pi{int(pi)}"]
        for f in want._fields:
            if getattr(want, f) is None:
                assert got[f] is None, f
            else:
                np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)), **TOL64,
                                           err_msg=f)


@pytest.mark.parametrize("lam", trc.KOOP_LAMS)
def test_sharded_streaming_stats_match_the_jax_scan(lam, four_ranks, data):
    """24 rows a rank in chunks of 10, on statistics that hold a prior
    segment; the halos and the downstream decay give the single-device
    scan's pairs and weights."""
    X, U = _j(data["koop_X"]), _j(data["koop_U"])
    s0 = jk.streaming_update(jk.streaming_init(_j(data["koop_C"]), trc.KOOP_GAMMA, 2,
                                               dtype=jnp.float64),
                             _j(data["koop_X_prior"]), _j(data["koop_U_prior"]), lam)
    want = jk.streaming_scan(s0, X, U, 10, lam)
    for r in four_ranks:
        got = r[f"koop_stream_{lam}"]
        for f in ("gram", "rhs", "weight_sum", "prev_z", "prev_u", "prev_valid", "centers"):
            np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)), **TOL64, err_msg=f)
        assert r["koop_stream_indivisible"] == f"N={trc.KOOP_N - 1} not divisible by mesh axis 4"


def test_world1_sharded_koopman_equals_the_single_device_functions(mesh1, data):
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    model, X, U = trc.koopman_model(d), d["koop_X"], d["koop_U"]
    mesh2 = pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    for method in ("scan", "conv"):
        np.testing.assert_allclose(
            float(sharded.sharded_koopman_multistep_rmse(mesh2, model, X, U, 5, method=method)),
            float(tk.multistep_rmse(model, X, U, 5, method=method)), **TOL64)
    got = sharded.sharded_koopman_fit(mesh1, None, X, U, trc.KOOP_K, trc.KOOP_GAMMA,
                                      trc.KOOP_RIDGE, 0, init=d["koop_C"])
    want = tk.fit(None, X, U, trc.KOOP_K, trc.KOOP_GAMMA, trc.KOOP_RIDGE, 0, init=d["koop_C"])
    np.testing.assert_allclose(got.A.numpy(), want.A.numpy(), **TOL64)
    s0 = trc.koopman_stats0(d, 0.97)
    got = sharded.sharded_streaming_stats(mesh1, s0, X, U, 10, 0.97)
    want = tk.streaming_scan(s0, X, U, 10, 0.97)
    np.testing.assert_allclose(got.gram.numpy(), want.gram.numpy(), **TOL64)


# --- data-parallel PINc training ------------------------------------------------------

def test_pinc_dp_training_matches_jax_and_one_device(four_ranks, pinc_inputs):
    d = pinc_inputs[0]
    for w in (8, 6):          # windows split over the ranks / taken by every rank
        net, hist = trc.pinc_train(d, rollout_windows=w)
        want = {k: v.numpy() for k, v in net.state_dict().items()}
        for r in four_ranks:
            got_hist, got = r[f"pinc_w{w}"]
            np.testing.assert_allclose(got_hist, hist, rtol=1e-5, err_msg=f"w={w}")
            if w == 8:
                np.testing.assert_allclose(got_hist, d["hist"], rtol=1e-5)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=f"{k} w={w}")
    n = d["z"].shape[0]
    for r in four_ranks:
        assert r["pinc_indivisible"] == (f"effective batch 62 (min(tc.batch=62, N={n})) must "
                                         "divide over the 4-way 'data' mesh axis")


def test_world1_pinc_training_equals_one_device(mesh1, pinc_inputs):
    d = pinc_inputs[0]
    net1, hist1 = trc.pinc_train(d, mesh1)
    net, hist = trc.pinc_train(d)
    assert hist1 == hist
    assert all(torch.equal(a, b) for a, b in zip(net1.parameters(), net.parameters()))


# --- MPPI over the sample axis ----------------------------------------------------

def test_sharded_mppi_matches_the_one_process_run(four_ranks, data):
    """The sample axis split over 4 ranks (16 and 15 samples a rank): the
    draws are the one-process run's, the reductions reordered."""
    want = trc.mppi_runs(data)
    for n in trc.MPPI_SAMPLES:
        X, U = want[f"mppi_{n}"]
        for r in four_ranks:
            got = r[f"mppi_{n}"]
            np.testing.assert_allclose(got[0], X, **TOL64, err_msg=f"X, {n} samples")
            np.testing.assert_allclose(got[1], U, **TOL64, err_msg=f"U, {n} samples")
        # and it regulates (the sampled plan is doing work)
        assert np.linalg.norm(X[-1]) < 0.3 * np.linalg.norm(data["mppi_x0"])


def test_world1_sharded_mppi_equals_one_process(mesh1, data):
    got, want = trc.mppi_runs(data, mesh1), trc.mppi_runs(data)
    for n in trc.MPPI_SAMPLES:
        for g, w in zip(got[f"mppi_{n}"], want[f"mppi_{n}"]):
            assert np.array_equal(g, w)


# --- the rank launcher ----------------------------------------------------------

def test_run_ranks_raises_when_a_rank_dies():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 died with exit code 3"):
        launch.run_ranks(trc.die_on_rank_2, trc.WORLD, timeout=60)
    assert time.monotonic() - t0 < 60


def test_run_ranks_raises_within_its_timeout_when_a_rank_hangs():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.run_ranks(trc.hang_on_rank_1, trc.WORLD, timeout=5)
    assert time.monotonic() - t0 < 5 + 15  # the timeout plus stopping the processes


# --- one rank, in this process ----------------------------------------------------

def test_make_mesh_without_a_group_names_the_helper(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_group"):
        pmesh.make_mesh()


def _window_fns(p, cfg, lag):
    """(sharded wrapper, single-device evaluator, X, input) of each of the
    three input contracts on torch tensors from the rank checks' inputs."""
    d = {k: torch.from_numpy(v) for k, v in trc.inputs().items()}
    return {
        "thruster": (lambda m, X, U: sharded.shardmap_endpoint_rmse_cuda(
            m, p, cfg, lag, X, U, DT, H, method="euler"),
            ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "euler"), d["X12"], d["U8"]),
        "wrench": (lambda m, X, U: sharded.shardmap_endpoint_rmse_cuda_wrench(
            m, p, X, U, DT, H, method="euler"),
            ce.make_endpoint_final_cuda_wrench(p, DT, H, "euler"), d["X12"], d["TAU6"]),
        "quat": (lambda m, X, U: sharded.shardmap_endpoint_rmse_cuda_quat(
            m, p, X, U, DT, H, method="euler"),
            cq.make_endpoint_final_cuda_quat(p, DT, H, "euler"), d["X13"], d["TAU6"]),
    }


def _cpu_consts():
    return (tparams.fossen_params(device="cpu"), tparams.thruster_config(device="cpu"),
            tparams.lag_params(DT, device="cpu"))


@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_world1_window_rmse_equals_the_unsharded_evaluator(kind, mesh1):
    wrapper, final_fn, X, U = _window_fns(*_cpu_consts())[kind]
    got = wrapper(mesh1, X, U)
    want = rmse(X[H:], final_fn(X, U))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_world1_offset_blocks_sum_to_the_world1_result(kind, mesh1):
    """Four contiguous blocks through the per-rank body give the squared
    error of the whole, as ranks 0-3 of four would."""
    wrapper, final_fn, X, U = _window_fns(*_cpu_consts())[kind]
    n_start, n = X.shape[0] - H, X.shape[1]
    m = n_start // 4
    sq = sum(sharded.window_block_sq(final_fn, X, U, H, r * m, m) for r in range(4))
    np.testing.assert_allclose(float(torch.sqrt(sq / (n_start * n))),
                               float(wrapper(mesh1, X, U)), rtol=1e-5)


@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_world1_fused_composition_equals_the_unfused_one(kind, mesh1):
    """K7 with the fused per-rank body (one call returning the block's
    squared-error sum) equals K7 with the unfused body (endpoints, then
    ``torch.sum``) on CPU tensors, where both are the plain versions."""
    p, cfg, lag = _cpu_consts()
    wrapper, final_fn, X, U = _window_fns(p, cfg, lag)[kind]
    unfused = sharded.shardmap_window_rmse(
        mesh1, lambda Xb, Ub: sharded.window_block_sq(final_fn, Xb, Ub, H, 0, Xb.shape[0] - H),
        X, U, H)
    before = dict(_build.launches)
    fused = wrapper(mesh1, X, U)
    assert _build.launches == before
    assert float(fused) == float(unfused)


def test_world1_step_loops_equal_the_single_device_metric(mesh1, data):
    lin = trc.linear_step(data)
    X, U = torch.from_numpy(data["X_lin"]), torch.from_numpy(data["U_lin"])
    from bluerov2_dynamics_tpu_torch.eval.metrics import endpoint_rmse
    for fn in (sharded.sharded_endpoint_rmse, sharded.shardmap_endpoint_rmse):
        np.testing.assert_allclose(float(fn(mesh1, lin, X, U, 9)),
                                   float(endpoint_rmse(lin, X, U, 9)), **TOL64)
    step = trc.fossen_step()
    x0, TAU = torch.from_numpy(data["x0"]), torch.from_numpy(data["TAU_roll"])
    x = x0
    for t in range(25):
        x = step(x, TAU[t])
    np.testing.assert_allclose(sharded.sharded_rollout_final(mesh1, step, x0, TAU, 25).numpy(),
                               x.numpy(), **TOL64)
    with pytest.raises(ValueError, match="rows for T"):
        sharded.sharded_rollout_final(mesh1, step, x0, TAU, 24)


def test_init_group_twice_raises(mesh1):
    with pytest.raises(RuntimeError, match="already"):
        pmesh.init_group("gloo")


def test_window_views_keep_the_kernels_alignment():
    """Every rank's views of contiguous inputs pass the kernels' row
    alignment checks (U rows 32 bytes against 16, TAU rows 24 against 8);
    a view that starts off a row boundary does not."""
    d = {k: torch.from_numpy(v) for k, v in trc.inputs().items()}
    m = (trc.N_WINDOW - H) // trc.WORLD
    for r in range(trc.WORLD):
        ce.check_aligned(d["U8"][r * m:r * m + m + H], "U", 16)
        ce.check_aligned(d["TAU6"][r * m:r * m + m + H], "TAU", 8)
    with pytest.raises(ValueError, match="aligned"):
        ce.check_aligned(d["U8"].view(-1)[1:1 + 8 * 20].view(20, 8), "U", 16)


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["thruster", "wrench", "quat"])
def test_world1_window_kernels_on_card(kind, cuda, mesh1):
    """gloo all-reduces the CUDA partial sum through the host; one launch
    of the fused per-rank kernel, equal to the unsharded kernel's RMSE."""
    p, cfg, lag = (c.to(cuda) for c in _cpu_consts())
    wrapper, final_fn, X, U = _window_fns(p, cfg, lag)[kind]
    X, U = X.to(cuda), U.to(cuda)
    name = {"thruster": "window_sq", "wrench": "window_sq_wrench",
            "quat": "window_sq_quat"}[kind]
    before = _build.launches[name]
    got = float(wrapper(mesh1, X, U))
    assert _build.launches[name] == before + 1
    np.testing.assert_allclose(got, float(rmse(X[H:], final_fn(X, U))), rtol=1e-5)


@pytest.mark.cuda
def test_misaligned_view_raises_on_card(cuda, mesh1):
    p, cfg, lag = (c.to(cuda) for c in _cpu_consts())
    X = torch.zeros(40, 12, device=cuda)
    U = torch.zeros(41 * 8, device=cuda)[1:1 + 40 * 8].view(40, 8)
    with pytest.raises(ValueError, match="aligned"):
        sharded.shardmap_endpoint_rmse_cuda(mesh1, p, cfg, lag, X, U, DT, 10)


# --- the Fossen identification, data-parallel -----------------------------------

def _check_sysid(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith(".losses"):
            np.testing.assert_allclose(g, w, rtol=2e-4, err_msg=key)
        elif ".stderr." in key:
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=key)
            np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-3,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def sysid_single(data):
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    return trc.sysid_fits(d)


def test_sysid_fit_on_four_ranks_matches_one_device(four_ranks, sysid_single):
    assert np.isinf(sysid_single["thruster.stderr.s"][[12, 14, 16]]).all()
    for r in four_ranks:
        _check_sysid(r["sysid"], sysid_single)


def test_world1_sysid_mesh_fit_matches_one_device(mesh1, data, sysid_single):
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    _check_sysid(trc.sysid_fits(d, mesh1), sysid_single)


# --- filter banks -------------------------------------------------------------------

def _one_process_banks(data, B):
    """The port's unsharded EKF and PF banks of the first ``B`` trajectories."""
    from bluerov2_dynamics_tpu_torch.models import estimation as te

    d = {k: torch.from_numpy(v) for k, v in data.items()}
    step, h, Q, R, P0 = trc.bank_model(d)
    m0, U, Y = trc.bank_args(d, B)
    ekf = te.ekf(step, h, Q, R, m0, P0, U, Y, batched=True)
    m0, U, Y = trc.bank_args(d, B, pf=True)
    pf = te.particle_filter_bank(step, h, Q, R, m0, P0, U, Y, n_particles=trc.BANK_PARTICLES,
                                 seed=trc.BANK_SEED)
    return ekf, pf


@pytest.mark.parametrize("B", trc.BANK_SIZES)
def test_sharded_ekf_bank_matches_one_process_and_jax(B, four_ranks, data):
    """Each rank's gathered bank against the one-process bank (rtol 1e-9)
    and its first and last rows against the JAX package's single filter
    (``tests/test_parallel.py``'s tolerances)."""
    from bluerov2_dynamics_tpu.models import estimation as je

    one, _ = _one_process_banks(data, B)
    A, Bm = jnp.asarray(data["A"]), jnp.asarray(data["B"])
    jstep = lambda x, u: x @ A + u @ Bm  # noqa: E731
    m0, U, Y = (a.numpy() for a in trc.bank_args({k: torch.from_numpy(v) for k, v in
                                                   data.items()}, B))
    for r in four_ranks:
        got = r[f"ekf_bank_{B}"]
        for g, w in zip(got, one):
            np.testing.assert_allclose(g, w.numpy(), **TOL64)
        for b in (0, B - 1):
            want = je.ekf(jstep, lambda x: x[:2], jnp.eye(3) * 1e-4, jnp.eye(2) * 1e-2, m0[b],
                          jnp.eye(3) * 0.1, U[b], Y[b])
            np.testing.assert_allclose(got[0][b], np.asarray(want.means), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(got[1][b], np.asarray(want.covs), rtol=1e-5, atol=1e-10)
            np.testing.assert_allclose(got[2][b], float(want.loglik), rtol=1e-8)
        assert "transition inputs per trajectory" in r["bank_short_u"]


@pytest.mark.parametrize("B", trc.BANK_SIZES)
def test_sharded_pf_bank_matches_one_process(B, four_ranks, data):
    """Per-trajectory streams: the bank split over 4 ranks equals the
    one-process bank (the JAX package's ``fold_in`` property)."""
    _, one = _one_process_banks(data, B)
    for r in four_ranks:
        for g, w in zip(r[f"pf_bank_{B}"], one):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-9, atol=1e-12)


def test_world1_sharded_banks_equal_the_unsharded_banks(mesh1, data):
    """At world 1 the sharded banks are the unsharded ones, bit for bit."""
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    step, h, Q, R, P0 = trc.bank_model(d)
    for B in trc.BANK_SIZES:
        ekf, pf = _one_process_banks(data, B)
        m0, U, Y = trc.bank_args(d, B)
        got = sharded.sharded_ekf_bank(mesh1, step, h, Q, R, m0, P0, U, Y)
        assert all(torch.equal(g, w) for g, w in zip(got, ekf))
        m0, U, Y = trc.bank_args(d, B, pf=True)
        got = sharded.sharded_pf_bank(mesh1, step, h, Q, R, m0, P0, U, Y, seed=trc.BANK_SEED,
                                      n_particles=trc.BANK_PARTICLES)
        assert all(torch.equal(g, w) for g, w in zip(got, pf))

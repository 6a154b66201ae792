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
step loops (``tests/test_parallel.py:32-66``).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import torch_rank_checks as trc
from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.ops import pallas_eval as jpe
from bluerov2_dynamics_tpu.ops import pallas_quat as jpq
from bluerov2_dynamics_tpu.parallel import mesh as jmesh
from bluerov2_dynamics_tpu.parallel import sharded as jsharded
from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
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
def four_ranks():
    """Every port-side value of the 4-rank checks, one dict per rank."""
    return launch.run_ranks(trc.all_checks, trc.WORLD, backend="gloo", timeout=120)


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
    of the per-rank kernel, equal to the unsharded kernel's RMSE."""
    p, cfg, lag = (c.to(cuda) for c in _cpu_consts())
    wrapper, final_fn, X, U = _window_fns(p, cfg, lag)[kind]
    X, U = X.to(cuda), U.to(cuda)
    name = {"thruster": "window_eval", "wrench": "window_eval_wrench",
            "quat": "window_eval_quat"}[kind]
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

"""The port's slices end to end on the CPU: the tank apps' Fossen
evaluators (T2 thruster, T3 wrench, T4 quat13) against the JAX package's,
the data helpers they use, the evaluator metrics, device policy, and the
rule that the port imports neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.apps import common as jcommon
from bluerov2_dynamics_tpu.apps import tank_koopman as japp
from bluerov2_dynamics_tpu.data import csv_loader as jcsv
from bluerov2_dynamics_tpu.data import wrench as jwrench
from bluerov2_dynamics_tpu.eval import metrics as jmetrics
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu_torch.apps import tank_koopman as tapp
from bluerov2_dynamics_tpu_torch.apps import tank_wrench_comp as tapp3
from bluerov2_dynamics_tpu_torch.apps import tank_wrench_quat as tapp4
from bluerov2_dynamics_tpu_torch.data import csv_loader as tcsv
from bluerov2_dynamics_tpu_torch.data import wrench as twrench
from bluerov2_dynamics_tpu_torch.eval import metrics as tmetrics
from bluerov2_dynamics_tpu_torch.eval import timing as ttiming

REPO = Path(__file__).resolve().parent.parent
DT = 0.02


def _recording(rng, N=70):
    jp = jparams.fossen_params(dtype=jnp.float32)
    jcfg = jparams.thruster_config(dtype=jnp.float32)
    jlag = jparams.lag_params(DT, dtype=jnp.float32)
    U = np.clip(rng.normal(size=(N, 8)) * 0.4, -1, 1).astype(np.float32)
    x0 = jnp.zeros(12, jnp.float32).at[2].set(1.0)
    X = np.asarray(jfossen.simulate_thruster(jp, jcfg, jlag, x0, jnp.asarray(U), DT)[:-1])
    return (X + rng.normal(size=X.shape) * 1e-3).astype(np.float32), U


@pytest.mark.parametrize("H", [1, 5, 10])
def test_fossen_evaluator_matches_jax(H, rng):
    X, U = _recording(rng)
    want = float(japp.fossen_evaluator(DT, jnp.asarray(X), jnp.asarray(U))(H))
    got = tapp.fossen_evaluator(DT, X, U, device="cpu")(H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_fossen_evaluator_horizon_past_the_data_is_nan(rng):
    X, U = _recording(rng, N=12)
    run = tapp.fossen_evaluator(DT, X, U, device="cpu")
    assert np.isnan(float(run(12))) and np.isnan(float(run(40)))
    assert np.isnan(float(japp.fossen_evaluator(DT, jnp.asarray(X), jnp.asarray(U))(12)))


def _jax_wrench_evaluator(X, TAU, state):
    """The JAX apps' evaluator policy on the CPU: the scan branch of
    ``common.endpoint_evaluator_with_pallas`` (tank_wrench_comp.py:65-81,
    tank_wrench_quat.py:66-84)."""
    X, TAU = jnp.asarray(X, jnp.float32), jnp.asarray(TAU, jnp.float32)
    step = jfossen.make_wrench_step(jparams.fossen_params(dtype=jnp.float32), DT,
                                    method="euler", state=state)
    return jcommon.endpoint_evaluator_with_pallas(
        X, TAU, build_pallas=None,
        scan_eval=lambda H: jmetrics.endpoint_rmse(step, X, TAU, H))


@pytest.mark.parametrize("H", [1, 5, 10])
def test_fossen_wrench_evaluator_matches_jax(H, rng):
    X, W = tapp3.wrench_dataset(*_recording(rng))
    want = float(_jax_wrench_evaluator(X, W, "euler12")(H))
    got = tapp3.fossen_wrench_evaluator(DT, X, W, device="cpu")(H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("H", [1, 5, 10])
def test_fossen_quat_evaluator_matches_jax(H, rng):
    X13, W = tapp4.quat_dataset(*_recording(rng))
    want = float(_jax_wrench_evaluator(X13, W, "quat13")(H))
    got = tapp4.fossen_quat_evaluator(DT, X13, W, device="cpu")(H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_wrench_and_quat_evaluators_horizon_past_the_data_is_nan(rng):
    X, U = _recording(rng, N=12)
    X3, W = tapp3.wrench_dataset(X, U)
    X4, _ = tapp4.quat_dataset(X, U)
    run3 = tapp3.fossen_wrench_evaluator(DT, X3, W, device="cpu")
    run4 = tapp4.fossen_quat_evaluator(DT, X4, W, device="cpu")
    for H in (12, 40):
        assert np.isnan(float(run3(H))) and np.isnan(float(run4(H)))
    assert np.isnan(float(_jax_wrench_evaluator(X4, W, "quat13")(12)))


def test_wrench_and_quat_datasets_match_the_jax_copies(rng):
    X, U = _recording(rng, N=20)
    np.testing.assert_allclose(twrench.effectiveness_matrix(), jwrench.effectiveness_matrix(),
                               rtol=0, atol=0)
    assert twrench.ROTOR_TABLE == jwrench.ROTOR_TABLE
    np.testing.assert_allclose(twrench.thrusters_to_wrench(U), jwrench.thrusters_to_wrench(U),
                               rtol=1e-15, atol=1e-15)
    Xd = X.astype(np.float64)
    np.testing.assert_allclose(tcsv.euler_to_quat_np(Xd[:, 3], Xd[:, 4], Xd[:, 5]),
                               jcsv.euler_to_quat_np(Xd[:, 3], Xd[:, 4], Xd[:, 5]),
                               rtol=1e-15, atol=1e-15)
    # the T4 recording: quaternions formed in float64 on the host, as
    # tank_wrench_quat.py::synthetic_quat_dataset does
    X13, W = tapp4.quat_dataset(X, U)
    assert X13.dtype == np.float64 and X13.shape == (20, 13) and W.shape == (20, 6)
    np.testing.assert_allclose(np.linalg.norm(X13[:, 3:7], axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(X13[:, 7:], Xd[:, 6:])


def test_device_none_raises_without_cuda(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, U = _recording(rng, N=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.fossen_evaluator(DT, X, U)
    X13, W = tapp4.quat_dataset(X, U)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp3.fossen_wrench_evaluator(DT, X, W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp4.fossen_quat_evaluator(DT, X13, W)
    with pytest.raises(RuntimeError):
        ttiming.cuda_event_time(lambda: None)


def test_endpoint_rmse_and_one_step_rmse_match_jax(rng):
    A = rng.normal(size=(4, 4)) * 0.2
    X = rng.normal(size=(30, 4))
    U = rng.normal(size=(30, 4))
    jstep = lambda x, u: x @ jnp.asarray(A) + 0.1 * jnp.asarray(u)  # noqa: E731
    tstep = lambda x, u: x @ torch.from_numpy(A) + 0.1 * u  # noqa: E731
    tX, tU = torch.from_numpy(X), torch.from_numpy(U)
    for H in (1, 4, 29):
        np.testing.assert_allclose(
            float(tmetrics.endpoint_rmse(tstep, tX, tU, H)),
            float(jmetrics.endpoint_rmse(jstep, jnp.asarray(X), jnp.asarray(U), H)),
            rtol=1e-10)
    assert np.isnan(float(tmetrics.endpoint_rmse(tstep, tX, tU, 30)))
    np.testing.assert_allclose(
        float(tmetrics.one_step_rmse(tstep, tX, tU)),
        float(jmetrics.one_step_rmse(jstep, jnp.asarray(X), jnp.asarray(U))), rtol=1e-10)


def test_sync_and_time_fn_on_host_tensors():
    x = torch.arange(6.0)
    res, secs = ttiming.time_fn(lambda a: (a * 2, {"k": a}), x, warmup=1, iters=2)
    assert torch.equal(res[0], x * 2) and secs >= 0.0
    assert ttiming.sync(x) is x


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port and ``chip_smoke.py`` in a fresh
    interpreter and check ``sys.modules`` by exact name: the port's own
    name starts with the JAX package's, so a prefix test would be wrong."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import bluerov2_dynamics_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) >= 31, names\n"
        "for m in ('ops.quaternion', 'ops.cuda_quat', 'data.wrench', 'data.csv_loader',\n"
        "          'apps.tank_wrench_comp', 'apps.tank_wrench_quat', 'parallel.mesh',\n"
        "          'parallel.sharded', 'parallel.launch', 'ops.cuda_probes', 'eval.op_counts'):\n"
        "    assert pkg.__name__ + '.' + m in names, m\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "def banned(m):\n"
        "    return any(m == b or m.startswith(b + '.') for b in\n"
        "               ('jax', 'jaxlib', 'flax', 'bench', 'bluerov2_dynamics_tpu'))\n"
        "print(sorted(m for m in sys.modules if banned(m)))\n"
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

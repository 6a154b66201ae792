"""The port's Koopman apps end to end on the CPU: T2 ``tank_koopman`` against
the JAX package's on one CSV and one JAX-saved model, and T1
``sim_koopman`` at a small size.

The JAX app fits and saves the model (``--save-model``); the port's app
loads it (``--load-model``), so both score the same weights on the same
float32 test split.  Tolerances: the RMSE table at rtol 1e-4 (measured:
Koopman rows within 5.3e-6, float32 propagation in another summation
order over up to 100 steps; the Fossen row within 1.1e-5, since the JAX
app scores it in float64 under the tests' x64 mode and the port in
float32), the open-loop prediction at atol 1e-4 (measured 3.1e-6 on
states up to 3.8, 119 steps).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pd = pytest.importorskip("pandas")

from bluerov2_dynamics_tpu.apps import tank_koopman as japp  # noqa: E402
from bluerov2_dynamics_tpu.data import csv_loader as jcsv  # noqa: E402
from bluerov2_dynamics_tpu.data import synthetic as js  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import sim_koopman as tsim  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import tank_koopman as tapp  # noqa: E402

N_ROWS = 600


@pytest.fixture(scope="module", autouse=True)
def jax_timers_once():
    """The JAX package's timers, as its apps use them, call each timed
    function once.  ``eval/timing.py``'s ``time_fn_cold_warm``, and
    ``time_fn`` with a warm-up, call it again for a warm time that no test
    reads, and get the same result; here the one call's seconds stand for
    both.  Every loaded module of the JAX package that holds one of the two
    functions gets the replacement, for the module's tests."""
    import sys
    import time

    from bluerov2_dynamics_tpu.eval import timing

    def cold_warm(fn, *args, iters=1, **kwargs):
        t0 = time.perf_counter()
        result = timing.sync(fn(*args, **kwargs))
        seconds = time.perf_counter() - t0
        return result, seconds, seconds

    def once(fn, *args, warmup=1, iters=1, **kwargs):
        result, seconds, _ = cold_warm(fn, *args, **kwargs)
        return result, seconds

    swaps = {timing.time_fn_cold_warm: cold_warm, timing.time_fn: once}
    with pytest.MonkeyPatch.context() as mp:
        for name, module in list(sys.modules.items()):
            if name.startswith("bluerov2_dynamics_tpu."):
                for attr in ("time_fn_cold_warm", "time_fn"):
                    if getattr(module, attr, None) in swaps:
                        mp.setattr(module, attr, swaps[getattr(module, attr)])
        yield


def _table(text):
    """``{model: [RMSE at H = 1, 10, 100]}`` from an app's metrics table."""
    block = text.split("[metrics] Endpoint RMSE")[1].split("[timings]")[0]
    rows = {}
    for line in block.splitlines()[3:]:
        m = re.match(r"\s+(.+?)\s+\|(.*)", line)
        if m:
            rows[m.group(1)] = [float(v) for v in m.group(2).split("|")]
    return rows


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A JAX-made pseudo recording as a thruster-contract CSV."""
    ds = js.generate_tank_recording(jax.random.PRNGKey(0), n_steps=N_ROWS, dtype=jnp.float32)
    cols = {"t": np.arange(N_ROWS) * ds.dt}
    cols.update({c: np.asarray(ds.X[:, i], np.float64) for i, c in enumerate(jcsv.EULER12_COLS)})
    cols.update({c: np.asarray(ds.U[:, i], np.float64) for i, c in enumerate(jcsv.THRUSTER_COLS)})
    path = tmp_path_factory.mktemp("rec") / "rec.csv"
    pd.DataFrame(cols).to_csv(path, index=False)
    return path


def test_tank_koopman_matches_jax_on_one_csv_and_one_model(recording, tmp_path, capsys):
    model = tmp_path / "koopman.npz"
    common = ["--csv", str(recording), "--physics-baseline", "--no-media", "--n-rbfs", "16",
              "--fossen-fit", "--fossen-fit-steps", "5"]
    want = japp.main(common + ["--save-model", str(model)])
    want_table = _table(capsys.readouterr().out)
    got = tapp.main(common + ["--load-model", str(model)], device="cpu")
    got_table = _table(capsys.readouterr().out)
    assert list(got_table) == list(want_table) == ["Koopman", "Fossen (BlueROV2)",
                                                   "Fossen (fitted)"]
    for name, row in want_table.items():
        np.testing.assert_allclose(got_table[name], row, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose([got["rmse"][name][H] for H in (1, 10, 100)], row,
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert got["pred"].shape == want["pred"].shape == (120, 12)
    np.testing.assert_array_equal(got["true"], want["true"])
    np.testing.assert_allclose(got["pred"], np.asarray(want["pred"]), rtol=0, atol=1e-4)
    assert got["fit_s"] == (0.0, 0.0) and len(got["test"].X) == 120


def test_tank_koopman_fits_when_no_model_is_given(recording, capsys):
    got = tapp.main(["--csv", str(recording), "--no-media", "--n-rbfs", "16", "--decoder",
                     "--koopman-conv", "--seed", "3"], device="cpu")
    table = _table(capsys.readouterr().out)
    assert list(table) == ["Koopman"] and all(np.isfinite(table["Koopman"]))
    assert got["model"].decoder.shape == (12, 28) and got["fit_s"][0] > 0.0


def test_sim_koopman_runs_small(capsys):
    got = tsim.main(["--steps", "600", "--n-rbfs", "16", "--no-media"], device="cpu")
    out = capsys.readouterr().out
    assert "One-step RMSE on test set" in out and "100-step RMSE on test set" in out
    assert sorted(got["rmse"]) == [1, 10, 100] and all(np.isfinite(list(got["rmse"].values())))
    assert got["pred"].shape == (121, 12) and len(got["test"].X) == 121   # split - 1
    np.testing.assert_array_equal(got["pred"][0], got["test"].X[0].astype(np.float32))


@pytest.mark.parametrize("app", [tapp, tsim])
def test_media_and_unported_flags_fail_with_their_roadmap_item(app, capsys, tmp_path):
    # media render now (they were refused before the port had its figures)
    short = ["--open-loop-steps", "5"] if app is tapp else ["--demo-steps", "5"]
    app.main(["--synthetic", "--steps", "50", "--n-rbfs", "8", "--media-dir", str(tmp_path),
              *short], device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [
        "tank_true_vs_koopman.gif" if app is tapp else "sim_true_vs_koopman.gif"]
    # T2 takes the Fossen fit's flags and checks their values; T1 has none,
    # as in the JAX package
    bad = ["--fossen-fit-delay", "2"] if app is tapp else ["--fossen-fit"]
    with pytest.raises(SystemExit):
        app.main(["--synthetic", "--steps", "50", "--no-media", *bad], device="cpu")
    err = capsys.readouterr().err
    assert ("argument --fossen-fit-delay: invalid choice" if app is tapp
            else "unrecognized arguments: --fossen-fit") in err

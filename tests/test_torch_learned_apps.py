"""The port's apps T3 (``tank_wrench_comp``), T4 (``tank_wrench_quat``), T5
(``tank_rk4``) and T6 (``tank_full_comparison``) end to end on the CPU
against the JAX package's, on one JAX-made recording written as CSVs.

Both sides score the same models: the DI gains and the Fossen rows are
deterministic; the Koopman model is the one the JAX app fits (the port's
fit is replaced by it, since k-means++ draws from another generator); the
small PINc (hidden 16, 16) is trained and saved by the JAX T6 app with
``--pinc-position-invariant`` and loaded by the port's without the flag,
so its sidecar must override it.  Each JAX app runs once (module
fixtures).

Tolerances: the RMSE tables at rtol 1e-4 (measured at most 1.1e-5, the
DI rows at H = 100: float32 gains from Grams summed in another order;
the Fossen rows within 1.0e-7, though the JAX apps score them in float64
under the tests' x64 mode and the port in float32), the printed tables
with atol 1e-6 more for their six decimals, the open-loop predictions at
atol 1e-4 (measured 3.4e-5).  The test split (120 rows) keeps 20 starts
at H = 100.
"""

import contextlib
import io
import json
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

pd = pytest.importorskip("pandas")

from bluerov2_dynamics_tpu.apps import common as jcommon  # noqa: E402
from bluerov2_dynamics_tpu.apps import tank_full_comparison as jt6  # noqa: E402
from bluerov2_dynamics_tpu.apps import tank_rk4 as jt5  # noqa: E402
from bluerov2_dynamics_tpu.apps import tank_wrench_comp as jt3  # noqa: E402
from bluerov2_dynamics_tpu.apps import tank_wrench_quat as jt4  # noqa: E402
from bluerov2_dynamics_tpu.data import csv_loader as jcsv  # noqa: E402
from bluerov2_dynamics_tpu.data import synthetic as js  # noqa: E402
from bluerov2_dynamics_tpu.data.wrench import thrusters_to_wrench  # noqa: E402
from bluerov2_dynamics_tpu_torch import convert  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import common as tcommon  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import tank_full_comparison as tt6  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import tank_rk4 as tt5  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import tank_wrench_comp as tt3  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import tank_wrench_quat as tt4  # noqa: E402

from test_torch_koopman_apps import jax_timers_once  # noqa: E402,F401  (autouse)

N_ROWS = 600
RTOL = 1e-4
COMMON = ["--no-media", "--n-rbfs", "16", "--open-loop-steps", "60"]
FIT = ["--fossen-fit", "--fossen-fit-steps", "5"]
PINC = ["--pinc-epochs", "3", "--pinc-hidden", "16", "16", "--pinc-psi-ssa"]


def _table(text):
    """``{model: [RMSE at H = 1, 10, 100]}`` from an app's metrics table."""
    block = text.split("[metrics] Endpoint RMSE")[1].split("[timings]")[0]
    rows = {}
    for line in block.splitlines()[3:]:
        m = re.match(r"\s+(.+?)\s+\|(.*)", line)
        if m:
            rows[m.group(1)] = [float(v) for v in m.group(2).split("|")]
    return rows


def _run(main, argv, **kw):
    """``(result, stdout)`` of an app's ``main``, with the Koopman model its
    fit returns in ``result["_koopman"]`` (JAX apps)."""
    seen = {}
    real = jcommon.fit_koopman_from_args

    def spy(*a, **k):
        out = real(*a, **k)
        seen["model"] = out[0]
        return out

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(jcommon, "fit_koopman_from_args", spy)
        out = main(argv, **kw)
    return out, buf.getvalue(), seen.get("model")


def _port(main, argv, jmodel):
    """The port app's ``main`` on the CPU with the JAX app's Koopman model."""
    model = convert.koopman_model_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jmodel._asdict().items()},
        dtype=torch.float32, device="cpu")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(tcommon, "fit_koopman_from_args", lambda *a, **k: (model, 0.0, 0.0))
        out = main(argv, device="cpu")
    return out, buf.getvalue()


def _check_tables(got_text, want_text, names):
    """The printed tables (six decimals: atol 1e-6 for the rounding),
    every entry finite."""
    got, want = _table(got_text), _table(want_text)
    assert list(got) == list(want) == names
    for name, row in want.items():
        assert np.isfinite(row).all(), name
        np.testing.assert_allclose(got[name], row, rtol=RTOL, atol=1e-6, err_msg=name)
    return got


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """A JAX-made pseudo recording as a thruster CSV and as a wrench CSV
    (Euler states, which the quaternion loader converts)."""
    ds = js.generate_tank_recording(jax.random.PRNGKey(0), n_steps=N_ROWS, dtype=jnp.float32)
    X, U = np.asarray(ds.X, np.float64), np.asarray(ds.U, np.float64)
    base = {"t": np.arange(N_ROWS) * ds.dt}
    base.update({c: X[:, i] for i, c in enumerate(jcsv.EULER12_COLS)})
    d = tmp_path_factory.mktemp("rec")
    thr = dict(base, **{c: U[:, i] for i, c in enumerate(jcsv.THRUSTER_COLS)})
    W = thrusters_to_wrench(U)
    wr = dict(base, **{c: W[:, i] for i, c in enumerate(jcsv.WRENCH_COLS)})
    pd.DataFrame(thr).to_csv(d / "thr.csv", index=False)
    pd.DataFrame(wr).to_csv(d / "wrench.csv", index=False)
    return d


@pytest.fixture(scope="module")
def t6_jax(csvs):
    """The JAX T6 app: trains the small PINc position-invariant and saves
    it (and its sidecar); then the JAX T5 app on that checkpoint."""
    ckpt = csvs / "pinc.msgpack"
    args = ["--csv", str(csvs / "thr.csv"), *COMMON, *PINC, *FIT, "--pinc-ckpt", str(ckpt)]
    t6 = _run(jt6.main, args + ["--pinc-position-invariant"])
    t5 = _run(jt5.main, args + ["--pinc-position-invariant"])
    return dict(args=args, ckpt=ckpt, t6=t6, t5=t5)


T6_ROWS = ["Koopman", "Fossen (BlueROV2)", "Double Integrator", "PINc (ResDNN)", "PINc (ssa psi)",
           "Fossen (fitted)"]


def test_t6_matches_jax_with_the_sidecar_overriding_the_flag(t6_jax, tmp_path):
    assert json.loads(t6_jax["ckpt"].with_suffix(".msgpack.json").read_text()) == {
        "hidden": [16, 16], "normalize": False, "position_invariant": True,
        "lr_schedule": "const", "epochs": 3}
    (jout, jtext, jmodel) = t6_jax["t6"]
    json_out = tmp_path / "run.json"
    got, text = _port(tt6.main, t6_jax["args"] + ["--json-out", str(json_out)], jmodel)
    assert "Checkpoint sidecar overrides --pinc-position-invariant -> True" in text
    assert "[notice] Loaded a TUNED (non-reference) PINc checkpoint: position_invariant" in text
    assert got["net"].position_invariant and got["net"].hidden == (16, 16)
    table = _check_tables(text, jtext, T6_ROWS)
    assert table["PINc (ssa psi)"] != table["PINc (ResDNN)"]
    for name in T6_ROWS:
        np.testing.assert_allclose([got["rmse"][name][H] for H in (1, 10, 100)],
                                   [jout["rmses"][name][H] for H in (1, 10, 100)], rtol=RTOL,
                                   err_msg=name)
    for key, want in jout["trajs"].items():
        np.testing.assert_allclose(got["trajs"][key], np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=key)
    rec = json.loads(json_out.read_text())
    assert rec["backend"] == "cpu" and rec["fit_seconds_warm"]["pinc"] == 0.0
    assert set(rec["rmse"]) == set(T6_ROWS)
    assert list(got["rollout_s"]) == T6_ROWS[:4] + ["Fossen (fitted)"]
    assert "[timings] Open-loop rollout time" in text
    assert got["sysid"].losses.shape == (5,) and "FOSSEN (fitted)" in jout["trajs"]


def test_t5_rk4_matches_jax(t6_jax):
    (jout, jtext, jmodel) = t6_jax["t5"]
    got, text = _port(tt5.main, t6_jax["args"], jmodel)
    _check_tables(text, jtext, T6_ROWS)
    for name in T6_ROWS:
        np.testing.assert_allclose([got["rmse"][name][H] for H in (1, 10, 100)],
                                   [jout["rmses"][name][H] for H in (1, 10, 100)], rtol=RTOL,
                                   err_msg=name)
    # RK4 integrates both physics and DI: the rows differ from T6's Euler ones
    euler = _table(t6_jax["t6"][1])
    assert _table(text)["Double Integrator"] != euler["Double Integrator"]


def test_t3_matches_jax(csvs):
    args = ["--csv", str(csvs / "wrench.csv"), *COMMON, *FIT, "--fossen-fit-current"]
    jout, jtext, jmodel = _run(jt3.main, args)
    got, text = _port(tt3.main, args, jmodel)
    _check_tables(text, jtext, ["Koopman", "Fossen (wrench)", "Double Integrator",
                                "Fossen (fitted)"])
    assert got["sysid"].current.shape == (3,)
    for key in ("koopman", "fossen", "di"):
        np.testing.assert_allclose(got[key], np.asarray(jout[key]), rtol=0, atol=1e-4, err_msg=key)


def test_t4_matches_jax(csvs):
    args = ["--csv", str(csvs / "wrench.csv"), *COMMON, *FIT]
    jout, jtext, jmodel = _run(jt4.main, args)
    got, text = _port(tt4.main, args, jmodel)
    _check_tables(text, jtext, ["Koopman (quat)", "Fossen (quat)", "DI (quat)",
                                "Fossen (fitted)"])
    for key in ("koopman", "fossen", "di"):
        np.testing.assert_allclose(got[key], np.asarray(jout[key]), rtol=0, atol=1e-4, err_msg=key)


def test_t3_t4_synthetic_branches_and_guards(tmp_path):
    small = ["--synthetic", "--steps", "400", "--no-media", "--n-rbfs", "8"]
    for main, n in ((tt3.main, 12), (tt4.main, 13)):
        out = main(small, device="cpu")
        assert out["test"].X.shape == (80, n) and out["test"].U.shape == (80, 6)
        for row in out["rmse"].values():     # 80 test rows: H = 100 is past the data
            assert np.isfinite([row[1], row[10]]).all() and np.isnan(row[100])
    media = tmp_path / "media"                                    # media render now
    tt3.main(small[:3] + ["--n-rbfs", "8", "--open-loop-steps", "5", "--media-dir", str(media)],
             device="cpu")
    assert [p.name for p in media.iterdir()] == ["tank_wrench_comparison.gif"]
    with pytest.raises(SystemExit):
        tt6.main(small + ["--pinc-ckpt", str(tmp_path / "missing.pt")], device="cpu")
    with pytest.raises(SystemExit, match="only 1 devices"):
        tt6.main(small + ["--pinc-ckpt", str(tmp_path / "new.msgpack"), "--pinc-dp", "2"],
                 device="cpu")
    assert not (tmp_path / "new.msgpack").exists()
    with pytest.raises(SystemExit):              # the fit's input delay is 0 or 1
        tt6.main(small + ["--fossen-fit", "--fossen-fit-delay", "2"], device="cpu")


def test_json_sanitize_and_rollout_table(capsys):
    rec = {"a": float("nan"), "b": [1.0, float("inf"), {"c": 2}], "d": (3, float("-inf"))}
    assert tcommon.json_sanitize(rec) == jcommon.json_sanitize(rec)
    json.dumps(tcommon.json_sanitize(rec), allow_nan=False)
    tcommon.print_rollout_timings({"Koopman": (0.5, 0.25)})
    assert "Koopman               |    0.250000 | 0.500000" in capsys.readouterr().out

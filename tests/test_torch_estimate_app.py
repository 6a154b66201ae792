"""The port's estimation app (``apps/estimate.py``) against the JAX
package's on the CPU.

A JAX-made pseudo recording is written as a thruster-contract CSV; both
apps filter it and their JSON records and ``--out-csv`` states are
compared.  For the synthetic branches with ground truth, the port's
``common.load_or_generate_with_truth`` is handed the JAX recording and its
truth, so both apps score the same data.  Where the port draws its own
randomness, it is handed the JAX app's instead: the Koopman filter's
model (k-means++ seeding) is the JAX app's fit, and the particle filter
runs on the JAX app's key splits (``particle_filter_from_draws``).
Everything runs in float32 in both apps.  Tolerances: log-likelihoods at
rtol 1e-5, mean NIS at rtol 1e-4, the RMSE tables at rtol 1e-4, the noise
fit's variances at rtol 1e-4 and the written states at atol 1e-5
(measured: 6.2e-6 after a 3-step float32 Fossen fit, 3.8e-7 without one;
1.6e-6; 5.0e-6; 9.5e-7; 1.9e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from bluerov2_dynamics_tpu.apps import estimate as japp  # noqa: E402
from bluerov2_dynamics_tpu.data import csv_loader as jcsv  # noqa: E402
from bluerov2_dynamics_tpu.data import synthetic as js  # noqa: E402
from bluerov2_dynamics_tpu.models import koopman as jkoopman  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import common as tcommon  # noqa: E402
from bluerov2_dynamics_tpu_torch.apps import estimate as tapp  # noqa: E402
from bluerov2_dynamics_tpu_torch.models import estimation as test_  # noqa: E402
from bluerov2_dynamics_tpu_torch.models import koopman as tkoopman  # noqa: E402

from test_torch_estimation import jax_pf_draws  # noqa: E402
from test_torch_koopman_apps import jax_timers_once  # noqa: E402,F401  (autouse)

N_CSV = 400
N_SYN = 200
LL = dict(rtol=1e-5)
NIS = dict(rtol=1e-4)
RMSE = dict(rtol=1e-4)


@pytest.fixture(scope="module")
def jax_recording():
    """The JAX generator's pseudo recording: the noisy states, commands and
    truth (float32), ``N_CSV`` rows."""
    return js.generate_tank_recording(jax.random.PRNGKey(0), n_steps=N_CSV, dtype=jnp.float32)


@pytest.fixture(scope="module")
def recording(jax_recording, tmp_path_factory):
    """The JAX recording as a thruster-contract CSV."""
    ds = jax_recording
    cols = {"t": np.arange(N_CSV) * ds.dt}
    cols.update({c: np.asarray(ds.X[:, i], np.float64) for i, c in enumerate(jcsv.EULER12_COLS)})
    cols.update({c: np.asarray(ds.U[:, i], np.float64) for i, c in enumerate(jcsv.THRUSTER_COLS)})
    path = tmp_path_factory.mktemp("rec") / "rec.csv"
    pd.DataFrame(cols).to_csv(path, index=False)
    return path


def _truth(ds, n: int):
    return (jcsv.Dataset(X=np.asarray(ds.X[:n], np.float64), U=np.asarray(ds.U[:n], np.float64),
                         t=np.arange(n) * ds.dt, dt=ds.dt),
            np.asarray(ds.X_true[:n], np.float64), 1)


def _hand_over(monkeypatch, out):
    monkeypatch.setattr(japp.common, "load_or_generate_with_truth", lambda *a, **k: out)
    monkeypatch.setattr(tcommon, "load_or_generate_with_truth", lambda *a, **k: out)
    return out


@pytest.fixture
def jax_truth(jax_recording, monkeypatch):
    """Both apps' ``--synthetic`` data is the JAX recording's first
    ``N_SYN`` rows: the JAX app's loader and the port's return it."""
    return _hand_over(monkeypatch, _truth(jax_recording, N_SYN))


def _syn(*extra):
    return ["--synthetic", "--recording", "--steps", str(N_SYN), "--no-media", *extra]


def _close_tables(got, want, **tol):
    assert list(got) == list(want)
    for name in want:
        for group, v in want[name].items():
            np.testing.assert_allclose(got[name][group], v, err_msg=f"{name} {group}",
                                       **(tol or RMSE))


def test_csv_ekf_smooth_fit_noise_matches_jax(recording, tmp_path):
    """``--smooth --fit-noise`` on one CSV: the records and the smoothed
    thruster-contract CSV."""
    args = ["--csv", str(recording), "--no-media", "--smooth", "--fit-noise",
            "--fit-noise-window", "200", "--fit-noise-seglen", "50", "--fit-noise-steps", "3"]
    want = japp.main(args + ["--out-csv", str(tmp_path / "j.csv"),
                             "--json-out", str(tmp_path / "j.json")])
    got = tapp.main(args + ["--out-csv", str(tmp_path / "t.csv"),
                            "--json-out", str(tmp_path / "t.json")], device="cpu")
    on_disk = json.loads((tmp_path / "t.json").read_text())
    assert on_disk["n_rows"] == N_CSV and on_disk["filter"] == "ekf"
    assert got["plant"] == want["plant"] == "nominal"
    np.testing.assert_allclose(got["loglik"], want["loglik"], **LL)
    np.testing.assert_allclose(got["nis_mean"], want["nis_mean"], **NIS)
    for k in ("negll_first", "negll_last"):
        np.testing.assert_allclose(got["fit_noise"][k], want["fit_noise"][k], rtol=1e-5)
    for k in ("q_var_diag", "r_var_diag"):
        np.testing.assert_allclose(got["fit_noise"][k], want["fit_noise"][k], rtol=1e-4)
    a = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    assert a.shape == b.shape == (N_CSV, 21)
    np.testing.assert_array_equal(a[:, [0] + list(range(13, 21))], b[:, [0] + list(range(13, 21))])
    np.testing.assert_allclose(a[:, 1:13], b[:, 1:13], rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", [
    ["--measure", "pose", "--smooth"],
    ["--filter", "ukf"],
    ["--smooth", "--fossen-fit", "--fossen-fit-steps", "3"],
], ids=["pose_smooth", "ukf", "fossen_fit"])
def test_synthetic_branches_match_jax(extra, jax_truth):
    want = japp.main(_syn(*extra))
    got = tapp.main(_syn(*extra), device="cpu")
    _close_tables(got["rmse_vs_truth"], want["rmse_vs_truth"])
    np.testing.assert_allclose(got["loglik"], want["loglik"], **LL)
    np.testing.assert_allclose(got["nis_mean"], want["nis_mean"], **NIS)
    np.testing.assert_allclose(got["nees_mean"], want["nees_mean"], rtol=1e-3)
    assert got["plant"] == want["plant"]


def test_koopman_filter_matches_jax_on_the_jax_model(jax_truth, monkeypatch):
    """``--filter koopman`` with the JAX app's own EDMDc fit."""
    X, U = jax_truth[0].X.astype(np.float32), jax_truth[0].U.astype(np.float32)
    n_tr = int(0.8 * N_SYN)
    jm = jkoopman.fit(jax.random.PRNGKey(0), jnp.asarray(X[:n_tr]), jnp.asarray(U[:n_tr]),
                      n_rbfs=16, gamma=1.0, ridge=1e-3)
    conv = lambda a: None if a is None else torch.as_tensor(np.asarray(a))  # noqa: E731
    tm = tkoopman.KoopmanModel(conv(jm.centers), conv(jm.gamma), conv(jm.A), conv(jm.B),
                               conv(jm.decoder), conv(jm.rbf_weights))
    monkeypatch.setattr(japp.common, "fit_koopman_from_args", lambda *a, **k: (jm, 0.0, 0.0))
    monkeypatch.setattr(tcommon, "fit_koopman_from_args", lambda *a, **k: (tm, 0.0, 0.0))
    argv = _syn("--filter", "koopman", "--n-rbfs", "16")
    want = japp.main(argv)
    got = tapp.main(argv, device="cpu")
    _close_tables(got["rmse_vs_truth"], want["rmse_vs_truth"])
    np.testing.assert_allclose(got["loglik"], want["loglik"], **LL)
    np.testing.assert_allclose(got["nis_mean"], want["nis_mean"], **NIS)


def test_particle_filter_matches_jax_on_its_draws(jax_truth, monkeypatch):
    """``--noise-scale 25 --filter pf``: the port's filter replays the JAX
    app's key splits (``PRNGKey(seed)``)."""
    def on_jax_draws(step, h, Q, R, m0, P0, U, Y, n_particles, seed, **kw):
        init, normals, uniforms = jax_pf_draws(jax.random.PRNGKey(seed), Y.shape[0],
                                               n_particles, m0.shape[0], jnp.float32)
        t = torch.as_tensor
        return test_.particle_filter_from_draws(step, h, Q, R, m0, P0, U, Y, t(init),
                                                t(normals), t(uniforms), **kw)

    monkeypatch.setattr(tapp.estimation, "particle_filter", on_jax_draws)
    argv = _syn("--noise-scale", "25", "--filter", "pf", "--pf-particles", "64", "--q", "1e-4")
    want = japp.main(argv)
    got = tapp.main(argv, device="cpu")
    _close_tables(got["rmse_vs_truth"], want["rmse_vs_truth"])
    np.testing.assert_allclose(got["loglik"], want["loglik"], **LL)
    np.testing.assert_allclose(got["ess_mean"], want["ess_mean"], rtol=1e-4)


def test_mhe_with_outliers_matches_jax(jax_recording, monkeypatch):
    """Both apps run MHE in float32, where Adam's normalised update turns
    the rounding of near-zero gradient components into steps of size
    ``lr``, window after window: the RMSE table and the final cost at rtol
    1e-1 (measured 4.3e-2 and 2.9e-2 over 35 windows).  The float64 parity
    of ``mhe`` on the same plant with outliers is
    ``test_torch_estimation.py``'s, at atol 1e-10 (measured 6e-12)."""
    _hand_over(monkeypatch, _truth(jax_recording, 40))
    argv = ["--synthetic", "--recording", "--steps", "40", "--no-media", "--outlier-frac",
            "0.03", "--filter", "mhe", "--q", "1e-4", "--mhe-window", "6", "--mhe-iters", "3"]
    want = japp.main(argv)
    got = tapp.main(argv, device="cpu")
    assert got["meas_loss"] == want["meas_loss"] == "huber"
    _close_tables(got["rmse_vs_truth"], want["rmse_vs_truth"], rtol=1e-1)
    np.testing.assert_allclose(got["mhe_final_cost"], want["mhe_final_cost"], rtol=1e-1)


def test_quat_contract_mekf_and_manifold_rts_match_jax(jax_truth, tmp_path):
    argv = _syn("--contract", "quat", "--smooth")
    want = japp.main(argv + ["--out-csv", str(tmp_path / "j.csv")])
    got = tapp.main(argv + ["--out-csv", str(tmp_path / "t.csv")], device="cpu")
    assert got["filter"] == want["filter"] == "mekf_quat13"
    _close_tables(got["rmse_vs_truth"], want["rmse_vs_truth"])
    np.testing.assert_allclose(got["loglik"], want["loglik"], **LL)
    np.testing.assert_allclose(got["nis_mean"], want["nis_mean"], **NIS)
    assert got["quat_norm_max_dev"] < 1e-5
    a = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv, match", [
    (["--synthetic", "--steps", "300", "--filter", "ukf", "--smooth", "--no-media"], "ekf"),
    (["--synthetic", "--steps", "900", "--filter", "mhe", "--no-media"], "800"),
    (["--csv", "/nonexistent.csv", "--outlier-frac", "0.1", "--no-media"], "SYNTHETIC"),
    (["--synthetic", "--filter", "koopman", "--measure", "pose", "--no-media"], "measure all"),
    (["--synthetic", "--filter", "koopman", "--fossen-fit", "--no-media"], "fossen-fit"),
    (["--csv", "/nonexistent.csv", "--refit-koopman", "--no-media"], "ground truth"),
    (["--synthetic", "--contract", "quat", "--fit-noise", "--no-media"], "--fit-noise"),
    (["--synthetic", "--contract", "quat", "--measure", "pose", "--no-media"], "measure pose"),
    (["--synthetic", "--contract", "quat", "--filter", "pf", "--no-media"], "filter pf"),
    # without --no-media the argv is validated as the JAX app's (the port
    # once refused it for want of figures)
    (["--synthetic", "--contract", "quat", "--refit-koopman"], "refit-koopman"),
], ids=["smooth", "mhe_rows", "outliers_csv", "koopman_pose", "koopman_fossen", "refit_csv",
        "quat_fit_noise", "quat_pose", "quat_filter", "media"])
def test_argv_validation_matches_the_jax_app(argv, match):
    """Each argv the JAX app refuses before any work, the port refuses
    too, with the same reason."""
    with pytest.raises(SystemExit, match=match):
        tapp.main(argv, device="cpu")
    with pytest.raises(SystemExit):
        japp.main(argv)

"""The port's Koopman streaming fit, (gamma, ridge) sweep with its NaN
guard, failed Cholesky solves and model files against the JAX package's.
Inputs, helpers and tolerances are ``tests/test_torch_koopman.py``'s (see
its docstring): float64 entry by entry, float32 fits by their endpoint
RMSEs, Gram sums within 2e-6 of their largest entry."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import koopman as jk
from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.models import koopman as tk
from test_torch_koopman import (  # noqa: F401  (jax_fits is a fixture)
    DTYPES, FIT32, K, NU, NX, RIDGE, _pair, _same_fit, _sums, jax_fits)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lam", [1.0, 0.99])
def test_streaming_matches_jax(dtype, lam, jax_fits):
    (Xj, Uj), (Xt, Ut) = _pair(dtype)
    jm = jax_fits[dtype]["fit"]
    centers = np.asarray(jm.centers)
    js0 = jk.streaming_init(jm.centers, 1.0, NU, dtype=Xj.dtype)
    ts0 = tk.streaming_init(torch.tensor(centers), 1.0, NU, dtype=Xt.dtype, device="cpu")
    jst = jk.streaming_scan(js0, Xj, Uj, 64, lam)
    tst = tk.streaming_scan(ts0, Xt, Ut, 64, lam)
    for f in ("gram", "rhs", "weight_sum", "prev_z", "prev_u", "prev_valid"):
        _sums(getattr(tst, f), getattr(jst, f), dtype, f)
    _same_fit(tk.streaming_finalize(tst, RIDGE), jk.streaming_finalize(jst, RIDGE), dtype, Xt, Ut)
    # an episode update: its N pairs, no boundary pair in or out
    je = jk.streaming_update_episode(jst, Xj[:21], Uj[:20], lam)
    te = tk.streaming_update_episode(tst, Xt[:21], Ut[:20], lam)
    assert float(te.prev_valid) == 0.0
    _same_fit(tk.streaming_finalize(te, RIDGE), jk.streaming_finalize(je, RIDGE), dtype, Xt, Ut)
    with pytest.raises(ValueError, match="episode update"):
        tk.streaming_update_episode(tst, Xt[:20], Ut[:20])
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        tk.streaming_scan(ts0, Xt, Ut, 0)
    jf = jk.fit_streaming(jax_fits[dtype]["key"], Xj, Uj, K, 1.0, RIDGE, 64, 10, False, lam)
    tf = tk.fit_streaming(None, Xt, Ut, K, 1.0, RIDGE, 64, 0, False, lam,
                          init=torch.tensor(np.asarray(jf.centers)))
    _same_fit(tf, jf, dtype, Xt, Ut)
    if lam == 1.0:                            # the batch fit's solve on the same pairs
        _same_fit(tf, jm, dtype, Xt, Ut)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fit_sweep_and_select_best_with_a_nan_combo_match_jax(dtype, jax_fits):
    (Xj, Uj), (Xt, Ut) = _pair(dtype)
    key = jax_fits[dtype]["key"]
    gammas, ridges = (0.5, 1.0), (RIDGE, -1e3, 1e-1)   # a negative ridge: not PD, NaN
    jms, jc = jk.fit_sweep(key, Xj[:180], Uj[:180], K, gammas, ridges, 10)
    tms, tc = tk.fit_sweep(None, Xt[:180], Ut[:180], K, gammas, ridges, 0,
                           init=torch.tensor(np.asarray(jms.centers[0])))
    assert tms.A.shape == (6, NX + K, NX + K) and tms.centers.shape == (6, K, NX)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    nan_j = np.isnan(np.asarray(jms.A)).reshape(6, -1).all(1)
    nan_t = torch.isnan(tms.A).reshape(6, -1).all(1).numpy()
    np.testing.assert_array_equal(nan_t, nan_j)
    assert nan_t.tolist() == [False, True, False] * 2
    ok = ~nan_t
    for c in np.flatnonzero(ok):
        _same_fit(tk.KoopmanModel(*(None if f is None else f[int(c)] for f in tms)),
                  jk.KoopmanModel(*(None if f is None else f[int(c)] for f in jms)), dtype,
                  Xt, Ut)
    jb, jcombo, jr = jk.select_best(jms, jc, Xj[180:], Uj[180:], 10)
    tb, tcombo, tr = tk.select_best(tms, tc, Xt[180:], Ut[180:], 10)
    np.testing.assert_array_equal(tcombo.numpy(), np.asarray(jcombo))
    np.testing.assert_array_equal(np.isnan(tr.numpy()), np.isnan(np.asarray(jr)))
    np.testing.assert_allclose(tr.numpy()[ok], np.asarray(jr)[ok],
                               rtol=1e-10 if dtype == "float64" else FIT32)
    _same_fit(tb, jb, dtype, Xt, Ut)
    with pytest.raises(RuntimeError, match="every swept"):
        tk.select_best(*tk.fit_sweep(None, Xt[:180], Ut[:180], K, (1.0,), (-1e3,), 0,
                                     init=tms.centers[0]), Xt[180:], Ut[180:], 10)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_gram_that_is_not_positive_definite_gives_nan_as_in_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    G = rng.normal(size=(20, 5))
    gram, rhs = G.T @ G, G.T @ rng.normal(size=(20, 2))
    for ridge in (1e-3, -1e3):
        want = np.asarray(jk._solve_normal_eqns(jnp.asarray(gram, jd), jnp.asarray(rhs, jd), ridge))
        got = tk._solve_normal_eqns(torch.tensor(gram, dtype=td), torch.tensor(rhs, dtype=td),
                                    ridge).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).all() == (ridge < 0)
        np.testing.assert_allclose(got, want, rtol=1e-10 if dtype == "float64" else 1e-4)


def test_models_saved_by_either_package_load_in_the_other(tmp_path, jax_fits):
    jm = jax_fits["float32"]["decoder"]
    jk.save_model(tmp_path / "j.npz", jm)
    tm = tk.load_model(tmp_path / "j.npz", device="cpu")
    for f in jm._fields:
        w = getattr(jm, f)
        if w is None:
            assert getattr(tm, f) is None
        else:
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(w))
    tk.save_model(tmp_path / "sub" / "t.npz", tm._replace(rbf_weights=torch.ones(NX)))
    back = jk.load_model(tmp_path / "sub" / "t.npz")
    np.testing.assert_array_equal(np.asarray(back.A), tm.A.numpy())
    np.testing.assert_array_equal(np.asarray(back.rbf_weights), np.ones(NX))
    with pytest.raises(KeyError, match="centers"):
        convert.koopman_model_from_numpy({"A": np.eye(2)}, device="cpu")


def test_normal_equations_precision_script_runs_small(capsys):
    from bluerov2_dynamics_tpu_torch.eval import normal_eqns

    out = normal_eqns.main(["--steps", "800", "--n-rbfs", "16", "--device", "cpu"])
    assert set(out["relative to float64"]) == {"float32", "float32 Gram, float64 solve", "port"}
    rel = out["relative to float64"]
    assert all(np.isfinite(v) for r in rel.values() for v in r.values())
    assert max(abs(v) for v in rel["port"].values()) < 1e-3
    assert '"float64 RMSE"' in capsys.readouterr().out

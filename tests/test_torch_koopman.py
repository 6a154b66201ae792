"""The port's Koopman EDMDc model (``models/koopman.py``), RBF lift
(``ops/lifting.py``) and k-means (``ops/kmeans.py``) against the JAX
package's, on numpy-seeded inputs far from the origin (an unwound psi near
30 rad, as on the tank recordings).

The port seeds k-means from a ``torch.Generator``, so the fits are held
given the same centers: the JAX model's centers go in as ``init=`` with
no Lloyd round, and the Lloyd rounds themselves are held from JAX's own
k-means++ seeding.  The streaming accumulator, the sweep and the
persistence are in ``tests/test_torch_koopman_fits.py``.

Tolerances: float64 at atol 1e-8 (measured: 1e-11).  Explicit float32
(the conftest turns on x64, so every float32 case casts its inputs) at
the bounds stated in each test.  The port forms and solves the normal
equations in float64 while the JAX package does so in float32
(``models/koopman.py``'s docstring says why), so the float32 fits differ
by the JAX solve's own rounding: with ridge 1e-3 on these states it
leaves A's weak directions free by up to ~1e-2, and float32 fits are held
by their endpoint RMSEs (rtol 2e-3; measured up to 7.6e-4), one model's
RMSEs at rtol 1e-4, and Gram sums within 2e-6 of their largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.models import koopman as jk
from bluerov2_dynamics_tpu.models.fossen import renormalize_quat13 as jrenorm
from bluerov2_dynamics_tpu.ops import kmeans as jkm
from bluerov2_dynamics_tpu.ops import lifting as jlift
from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.models import koopman as tk
from bluerov2_dynamics_tpu_torch.models.fossen import renormalize_quat13 as trenorm
from bluerov2_dynamics_tpu_torch.ops import kmeans as tkm
from bluerov2_dynamics_tpu_torch.ops import lifting as tlift
from bluerov2_dynamics_tpu_torch.ops import precision

N, NX, NU, K = 240, 6, 3, 12
RIDGE = 1e-3
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
# float32 bounds: the RMSE of one model (relative), matrices (absolute), and
# the RMSEs of the port's and the JAX package's float32 fits of one
# dictionary (relative; measured up to 7.6e-4: the JAX float32 solve's
# rounding, amplified by the Gram's conditioning)
RMSE32, MAT32, FIT32 = 1e-4, 5e-3, 2e-3


def _data(seed=0, n=NX):
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.normal(size=(N, n)) * 0.1, axis=0)
    X[:, min(5, n - 1)] += 30.0                       # a wound-up angle
    U = rng.normal(size=(N, NU))
    return X, U


def _pair(dtype, seed=0, n=NX):
    jd, td = DTYPES[dtype]
    X, U = _data(seed, n)
    return (jnp.asarray(X, jd), jnp.asarray(U, jd)), (torch.tensor(X, dtype=td),
                                                     torch.tensor(U, dtype=td))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tmodel(jm, td):
    return convert.koopman_model_from_numpy(
        {k: None if getattr(jm, k) is None else np.asarray(getattr(jm, k))
         for k in jm._fields}, dtype=td, device="cpu")


def _mat(got, want, dtype):
    tol = dict(rtol=0, atol=1e-8) if dtype == "float64" else dict(rtol=0, atol=MAT32)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _same_fit(tm, jm, dtype, Xt, Ut):
    """Two fits of one dictionary agree: in float64 entry by entry; in
    float32 by their H = 1 and 10 endpoint RMSEs on the data (the float32
    solve leaves A's ill-determined directions free by up to ~1e-2 here,
    which the predictions do not see)."""
    if dtype == "float64":
        _mat(tm.A, jm.A, dtype)
        _mat(tm.B, jm.B, dtype)
        return
    jt = _tmodel(jm, Xt.dtype)
    for H in (1, 10):
        np.testing.assert_allclose(float(tk.multistep_rmse(tm, Xt, Ut, H)),
                                   float(tk.multistep_rmse(jt, Xt, Ut, H)), rtol=FIT32)


def _sums(got, want, dtype, what):
    """Accumulated Gram-type sums: float64 at rtol 1e-10; float32 within
    2e-6 of the largest entry (sums of N products of states near 30)."""
    got, want = _np(got), _np(want)
    atol = 0 if dtype == "float64" else 2e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10 if dtype == "float64" else 1e-5,
                               atol=atol, err_msg=what)


def _scalar(got, want, dtype):
    tol = dict(rtol=1e-10) if dtype == "float64" else dict(rtol=RMSE32)
    np.testing.assert_allclose(float(got), float(want), **tol)


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX fits each test holds the port against, per dtype."""
    out = {}
    for dtype in DTYPES:
        (Xj, Uj), _ = _pair(dtype)
        key = jax.random.PRNGKey(1)
        m = jk.fit(key, Xj, Uj, K, 1.0, RIDGE, 10, False)
        out[dtype] = {"key": key, "fit": m, "fit_pi": jk.fit(key, Xj, Uj, K, 1.0, RIDGE, 10, True),
                      "decoder": jk.fit_decoder(m, Xj)}
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("weighted", [False, True])
def test_rbf_features_match_jax_far_from_the_origin(dtype, weighted):
    (Xj, _), (Xt, _) = _pair(dtype)
    rng = np.random.default_rng(1)
    C = _data(2)[0][rng.choice(N, K, replace=False)]
    w = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0]) if weighted else None
    want = jlift.rbf_lift(Xj, jnp.asarray(C, Xj.dtype), 0.7,
                          None if w is None else jnp.asarray(w, Xj.dtype))
    got = tlift.rbf_lift(Xt, torch.tensor(C, dtype=Xt.dtype), 0.7,
                         None if w is None else torch.tensor(w, dtype=Xt.dtype))
    assert got.shape == (N, NX + K) and bool(torch.all(got[:, NX:] <= 1.0))
    # float32: |x|^2 ~ 9e2 here, so the expansion's rounding is ~1e-4 of a distance
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=1e-12 if dtype == "float64" else 2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lloyd_rounds_from_jax_seeding_match_jax_kmeans(dtype):
    (Xj, _), (Xt, _) = _pair(dtype)
    key = jax.random.PRNGKey(4)
    init = jkm._kmeanspp_init(key, Xj, K)
    cj, aj = jkm.kmeans(key, Xj, K, 10)
    ct, at = tkm.kmeans(Xt, K, 10, init=torch.tensor(np.asarray(init)))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-5)
    np.testing.assert_allclose(_np(tkm._pairwise_sqdist(Xt, ct)),
                               _np(jkm._pairwise_sqdist(Xj, cj)), rtol=1e-5, atol=1e-3)


def test_kmeanspp_recovers_separated_clusters_and_is_deterministic():
    rng = np.random.default_rng(0)
    means = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [0, 0, 10.0]])
    X = torch.tensor(np.concatenate([m + 0.1 * rng.normal(size=(50, 3)) for m in means]))
    for seed in range(3):
        c1, a1 = tkm.kmeans(X, 4, 5, torch.Generator().manual_seed(seed))
        c2, a2 = tkm.kmeans(X, 4, 5, torch.Generator().manual_seed(seed))
        assert torch.equal(c1, c2) and torch.equal(a1, a2)
        found = sorted(map(tuple, np.round(c1.numpy()).astype(int).tolist()))
        assert found == sorted(map(tuple, means.astype(int).tolist()))
        assert sorted(np.bincount(a1.numpy()).tolist()) == [50] * 4
    # an empty cluster keeps its center; ties go to the first minimum
    init = torch.tensor([[0.0, 0, 0], [100.0, 100, 100], [0.0, 0, 0]], dtype=X.dtype)
    assert bool(torch.all(tkm.kmeans(X[:50], 3, 0, init=init)[1] == 0))
    assert torch.equal(tkm.kmeans(X[:50], 3, 2, init=init)[0][1], init[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pi", [False, True])
def test_fit_given_the_same_centers_matches_jax(dtype, pi, jax_fits):
    _, (Xt, Ut) = _pair(dtype)
    jm = jax_fits[dtype]["fit_pi" if pi else "fit"]
    tm = tk.fit(None, Xt, Ut, K, 1.0, RIDGE, 0, pi, init=torch.tensor(np.asarray(jm.centers)))
    _same_fit(tm, jm, dtype, Xt, Ut)
    assert float(tm.gamma) == float(jm.gamma) and tm.decoder is None
    assert (tm.rbf_weights is None) == (jm.rbf_weights is None)
    if pi:
        np.testing.assert_array_equal(tm.rbf_weights.numpy(), np.asarray(jm.rbf_weights))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fit_multi_and_fit_decoder_match_jax(dtype, jax_fits):
    (Xj, Uj), (Xt, Ut) = _pair(dtype)
    (Xj2, Uj2), (Xt2, Ut2) = _pair(dtype, seed=5)
    key = jax_fits[dtype]["key"]
    jm = jk.fit_multi(key, [Xj, Xj2[:100], Xj2[:1]], [Uj, Uj2[:100], Uj2[:1]], K, 1.0, RIDGE, 10)
    tm = tk.fit_multi(None, [Xt, Xt2[:100], Xt2[:1]], [Ut, Ut2[:100], Ut2[:1]], K, 1.0, RIDGE, 0,
                      init=torch.tensor(np.asarray(jm.centers)))
    _same_fit(tm, jm, dtype, Xt, Ut)
    with pytest.raises(ValueError, match="equal-length"):
        tk.fit_multi(None, [Xt], [Ut, Ut], K)
    jd = jax_fits[dtype]["decoder"]
    td = tk.fit_decoder(_tmodel(jax_fits[dtype]["fit"], Xt.dtype), Xt)
    _mat(td.decoder, jd.decoder, dtype)
    _scalar(tk.evaluate(td, Xt, Ut), tk.evaluate(_tmodel(jd, Xt.dtype), Xt, Ut), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_evaluate_and_simulate_match_jax(dtype, jax_fits):
    (Xj, Uj), (Xt, Ut) = _pair(dtype)
    for name in ("fit", "decoder"):
        jm = jax_fits[dtype][name]
        tm = _tmodel(jm, Xt.dtype)
        _scalar(tk.evaluate(tm, Xt, Ut), jk.evaluate(jm, Xj, Uj), dtype)
        _mat(tk.simulate(tm, Xt[3], Ut[3:33]), jk.simulate(jm, Xj[3], Uj[3:33]), dtype)
        # batched: x0 (B, n) under U (T, B, r)
        idx = np.array([0, 50, 120])
        Ub = np.stack([_np(Ut)[i:i + 20] for i in idx], axis=1)
        got = tk.simulate(tm, Xt[idx], torch.tensor(Ub))
        want = jk.simulate(jm, Xj[idx], jnp.asarray(Ub))
        assert got.shape == (21, 3, NX)
        _mat(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("method", ["scan", "conv"])
def test_multistep_rmse_matches_jax(dtype, method, jax_fits):
    (Xj, Uj), (Xt, Ut) = _pair(dtype)
    for name in ("fit", "decoder"):
        jm, tm = jax_fits[dtype][name], _tmodel(jax_fits[dtype][name], Xt.dtype)
        for H in (0, 1, 10):
            _scalar(tk.multistep_rmse(tm, Xt, Ut, H, method=method),
                    jk.multistep_rmse(jm, Xj, Uj, H, method=method), dtype)
    # post_decode on a quat13-shaped model: 13 states, renormalised predictions
    (Xq, Uq), (Xqt, Uqt) = _pair(dtype, seed=3, n=13)
    jm = jk.fit(jax_fits[dtype]["key"], Xq, Uq, K, 1.0, RIDGE, 3)
    tm = _tmodel(jm, Xqt.dtype)
    _scalar(tk.multistep_rmse(tm, Xqt, Uqt, 10, post_decode=trenorm, method=method),
            jk.multistep_rmse(jm, Xq, Uq, 10, "highest", jrenorm, method), dtype)


def test_multistep_nan_contract_and_method_check(jax_fits):
    _, (Xt, Ut) = _pair("float64")
    tm = _tmodel(jax_fits["float64"]["fit"], torch.float64)
    for H in (N, N + 5):
        assert np.isnan(float(tk.multistep_rmse(tm, Xt, Ut, H)))
    with pytest.raises(ValueError, match="'scan' or 'conv'"):
        tk.multistep_rmse(tm, Xt, Ut, 2, method="fft")
    # scan and conv are the same endpoint
    np.testing.assert_allclose(float(tk.multistep_rmse(tm, Xt, Ut, 25, method="conv")),
                               float(tk.multistep_rmse(tm, Xt, Ut, 25)), rtol=1e-9)


def test_full_f32_pins_tf32_off_and_restores_the_callers_settings(jax_fits):
    _, (Xt, Ut) = _pair("float32")
    tm = _tmodel(jax_fits["float32"]["fit"], torch.float32)
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    seen = []
    real = tk.rmse
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        assert precision.tf32_enabled()
        with precision.full_f32():
            assert not precision.tf32_enabled()
        tk.rmse = lambda a, b: (seen.append(precision.tf32_enabled()), real(a, b))[1]
        tk.multistep_rmse(tm, Xt, Ut, 5)
        tk.evaluate(tm, Xt, Ut)
        assert seen == [False, False]
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        tk.rmse = real
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def test_device_none_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.load_model(tmp_path / "none.npz")

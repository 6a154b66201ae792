"""The port's data generators (``bluerov2_dynamics_tpu_torch/data/synthetic.py``)
against the JAX package's.

The port draws from PyTorch's generator, not threefry, so the parity
tests feed the JAX generator's own draws into the port's ``*_from_draws``
functions: they replay its key splits (``synthetic.py:208-209`` and
``:242``, ``split(key)`` in the simulation dataset and in ``ar1_commands``)
and hold the datasets at atol 1e-9 in float64 and 1e-5 in float32 over
300 steps.  The rest pins the port's own streams: seed determinism, the
``(seed, 99)`` contract for optional draws.  The CUDA-graph loop is held
against the eager one on the card in ``tests/test_torch_cuda_koopman.py``,
which imports no JAX (the card's machine has no flax, which the JAX
package's ``data`` needs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.data import synthetic as js
from bluerov2_dynamics_tpu_torch.data import synthetic as ts

N_STEPS = 300
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-9),
          "float32": (jnp.float32, torch.float32, 1e-5)}
TANK_CASES = {
    "default": {},
    "gains_current": dict(thruster_gain_jitter=0.2, current=(0.1, -0.05, 0.0)),
    "noise_scale": dict(noise_scale=3.0),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tank_draws(key, n, jd, gain_jitter=0.0, jitter=0.10):
    """The draws of ``generate_tank_recording`` for ``key``, replayed."""
    k_p, k_u, k_n, k_x0 = jax.random.split(key, 4)
    draws = {
        "factors": np.asarray(jax.random.uniform(k_p, (23,), minval=1 - jitter,
                                                 maxval=1 + jitter)),
        "x0": _t(jax.random.normal(k_x0, (12,), jd)),
        "normals": _t(jax.vmap(lambda k: jax.random.normal(k, (8,), jd))(
            jax.random.split(k_u, n))),
        "noise": _t(jax.random.normal(k_n, (n, 12), jd)),
    }
    if gain_jitter > 0:
        draws["gains"] = _t(jax.random.uniform(jax.random.fold_in(key, 99), (8,), jd,
                                               minval=1 - gain_jitter, maxval=1 + gain_jitter))
    return draws


def _jax_sim_draws(key, n, jd):
    k_u, k_n = jax.random.split(key)
    return {"normals": _t(jax.vmap(lambda k: jax.random.normal(k, (8,), jd))(
                jax.random.split(k_u, n))),
            "noise": _t(jax.random.normal(k_n, (n, 12), jd))}


def _close(got, want, atol):
    for name in ("X", "X_true", "U"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)
    assert got.dt == want.dt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(TANK_CASES))
def test_tank_recording_from_jax_draws_matches_jax(case, dtype):
    jd, td, atol = DTYPES[dtype]
    kw = dict(TANK_CASES[case])
    key = jax.random.PRNGKey(3)
    draws = _jax_tank_draws(key, N_STEPS, jd, kw.get("thruster_gain_jitter", 0.0))
    want = js.generate_tank_recording(key, n_steps=N_STEPS, dtype=jd, **kw)
    kw.pop("thruster_gain_jitter", None)
    got = ts.generate_tank_recording_from_draws(draws, dtype=td, device="cpu", **kw)
    _close(got, want, atol)
    # psi winds and the holds keep the vehicle upright, as in the JAX recording
    assert float(got.X_true[:, 3:5].abs().max()) < 1.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sim_dataset_and_ar1_commands_from_jax_draws_match_jax(dtype):
    jd, td, atol = DTYPES[dtype]
    key = jax.random.PRNGKey(5)
    draws = _jax_sim_draws(key, N_STEPS, jd)
    want = js.generate_sim_dataset(key, n_steps=N_STEPS, dt=0.05, noise_scale=2.0, dtype=jd)
    got = ts.generate_sim_dataset_from_draws(draws, dt=0.05, noise_scale=2.0, dtype=td,
                                             device="cpu")
    _close(got, want, atol)
    k_u = jax.random.split(key)[0]
    np.testing.assert_allclose(ts.ar1_commands_from_draws(draws["normals"]).numpy(),
                               np.asarray(js.ar1_commands(k_u, N_STEPS, dtype=jd)),
                               rtol=0, atol=atol)


def test_perturbed_params_from_the_factors_match_jax():
    key = jax.random.PRNGKey(7)
    factors = np.asarray(jax.random.uniform(key, (23,), minval=0.8, maxval=1.2))
    want = js.perturbed_fossen_params(key, 0.2, dtype=jnp.float64)
    got = ts.perturbed_fossen_params(factors, dtype=torch.float64, device="cpu")
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-15, atol=1e-15, err_msg=name)
    # JAX's recording_coefficient_draws is the uniform draw fed above
    np.testing.assert_array_equal(js.recording_coefficient_draws(key, 0.2),
                                  np.asarray(jax.random.uniform(jax.random.split(key, 4)[0],
                                                                (23,), minval=0.8, maxval=1.2)))


def test_recording_coefficient_draws_are_the_recordings_factors():
    want = ts.recording_coefficient_draws(11, 0.15)
    assert want.dtype == np.float64 and want.shape == (23,)
    assert np.all(np.abs(want - 1.0) <= 0.15)
    for n in (10, 400):   # independent of the recording's length
        np.testing.assert_array_equal(ts.tank_recording_draws(11, n, 0.15)["factors"].numpy(),
                                      want)
    p = ts.perturbed_fossen_params(want, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(float(p.m), 13.5 * want[0], rtol=1e-15)


def test_seed_determinism():
    a = ts.generate_tank_recording(2, n_steps=64, device="cpu")
    b = ts.generate_tank_recording(2, n_steps=64, device="cpu")
    c = ts.generate_tank_recording(3, n_steps=64, device="cpu")
    for f in ("X", "X_true", "U"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert not torch.equal(getattr(a, f), getattr(c, f))
    s1 = ts.generate_sim_dataset(2, n_steps=64, device="cpu")
    s2 = ts.generate_sim_dataset(2, n_steps=64, device="cpu")
    assert torch.equal(s1.X, s2.X) and torch.equal(s1.U, s2.U)
    g = torch.Generator().manual_seed(4)
    u1 = ts.ar1_commands(g, 50, device="cpu")
    assert torch.equal(u1, ts.ar1_commands(torch.Generator().manual_seed(4), 50, device="cpu"))
    assert float(u1.abs().max()) <= 1.0


def test_an_optional_draw_leaves_the_default_draws_unchanged():
    plain = ts.tank_recording_draws(6, 128)
    jittered = ts.tank_recording_draws(6, 128, thruster_gain_jitter=0.1)
    assert "gains" not in plain and set(jittered) == set(plain) | {"gains"}
    for k in plain:
        assert torch.equal(plain[k], jittered[k]), k
    np.testing.assert_array_equal(
        jittered["gains"].numpy(),
        (0.9 + 0.2 * torch.rand(8, generator=ts.stream(6, ts.GAIN_TAG))).numpy())
    # the gains move the vehicle, not the commands' noise or the sensor noise
    a = ts.generate_tank_recording_from_draws(plain, device="cpu")
    b = ts.generate_tank_recording_from_draws(jittered, device="cpu")
    assert not torch.equal(a.X_true, b.X_true)
    torch.testing.assert_close(a.X - a.X_true, b.X - b.X_true, rtol=0, atol=1e-6)


def test_noise_scale_scales_the_same_draw():
    draws = ts.tank_recording_draws(1, 100)
    a = ts.generate_tank_recording_from_draws(draws, device="cpu")
    b = ts.generate_tank_recording_from_draws(draws, noise_scale=4.0, device="cpu")
    assert torch.equal(a.X_true, b.X_true) and torch.equal(a.U, b.U)
    torch.testing.assert_close(b.X - b.X_true, 4.0 * (a.X - a.X_true), rtol=1e-4, atol=1e-7)


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.generate_tank_recording(0, n_steps=4)

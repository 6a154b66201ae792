"""The port's quaternion functions against the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages.  Tolerances:
float64 cases agree to 1e-10 (same formulas, different libm); float32
cases to rtol 1e-6 / atol 1e-6, a few ulps of values of order one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bluerov2_dynamics_tpu.ops import quaternion as jq
from bluerov2_dynamics_tpu_torch.ops import quaternion as tq

TOL = {"float64": dict(rtol=1e-10, atol=1e-10), "float32": dict(rtol=1e-6, atol=1e-6)}
DTYPES = ["float32", "float64"]


def _pair(a, dtype):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want, dtype):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, dtype)
        return
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


def _quats(rng, n=9):
    return rng.normal(size=(n, 4)) * 1.5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_rotation_matrix", "quat_conjugate",
                                  "quat_to_euler", "quat_to_yaw", "quat_log"])
def test_unary_quaternion_functions_match_jax(name, dtype, rng):
    q = _quats(rng)
    if name == "quat_log":
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    jqq, tqq = _pair(q, dtype)
    _close(getattr(tq, name)(tqq), getattr(jq, name)(jqq), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["quat_rotate", "quat_rotate_inv", "quat_derivative"])
def test_quaternion_vector_functions_match_jax(name, dtype, rng):
    q = _quats(rng)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(9, 3))
    (jqq, tqq), (jv, tv) = _pair(q, dtype), _pair(v, dtype)
    _close(getattr(tq, name)(tqq, tv), getattr(jq, name)(jqq, jv), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quat_multiply_and_euler_conversions_match_jax(dtype, rng):
    (jq1, tq1), (jq2, tq2) = _pair(_quats(rng), dtype), _pair(_quats(rng), dtype)
    _close(tq.quat_multiply(tq1, tq2), jq.quat_multiply(jq1, jq2), dtype)
    ang = rng.uniform(-3.0, 3.0, size=(3, 9))
    ang[1] = np.clip(ang[1], -1.5, 1.5)
    (jphi, tphi), (jth, tth), (jpsi, tpsi) = (_pair(a, dtype) for a in ang)
    tquat = tq.euler_to_quat(tphi, tth, tpsi)
    _close(tquat, jq.euler_to_quat(jphi, jth, jpsi), dtype)
    # and back: the round trip returns the angles
    _close(tq.quat_to_euler(tquat), (jphi, jth, jpsi), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quat_exp_matches_jax_and_inverts_log(dtype, rng):
    rv = rng.normal(size=(9, 3)) * 0.8
    jrv, trv = _pair(rv, dtype)
    tquat = tq.quat_exp(trv)
    _close(tquat, jq.quat_exp(jrv), dtype)
    _close(tq.quat_log(tquat), jrv, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_normalize_falls_back_to_identity_below_eps(dtype):
    q = np.zeros((4, 4))
    q[1] = [1e-13, 0.0, 0.0, 0.0]                 # below the 1e-12 norm
    q[2] = [0.0, 3e-13, -2e-13, 0.0]
    q[3] = [0.0, 2.0, 0.0, 0.0]                   # a normal one stays itself
    jqq, tqq = _pair(q, dtype)
    got = tq.quat_normalize(tqq)
    _close(got, jq.quat_normalize(jqq), dtype)
    np.testing.assert_array_equal(got[:3].numpy(), np.tile([1.0, 0.0, 0.0, 0.0], (3, 1)))
    np.testing.assert_array_equal(got[3].numpy(), [0.0, 1.0, 0.0, 0.0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_exp_and_log_taylor_guards_at_zero(dtype):
    zero = np.zeros((2, 3))
    zero[1] = [1e-8, 0.0, -1e-8]                   # inside the guard
    jz, tz = _pair(zero, dtype)
    got = tq.quat_exp(tz)
    assert np.all(np.isfinite(got.numpy()))
    _close(got, jq.quat_exp(jz), dtype)
    np.testing.assert_array_equal(got[0].numpy(), [1.0, 0.0, 0.0, 0.0])
    ident = np.array([[1.0, 0.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    ji, ti = _pair(ident, dtype)
    got = tq.quat_log(ti)
    assert np.all(np.isfinite(got.numpy()))
    _close(got, jq.quat_log(ji), dtype)
    np.testing.assert_array_equal(got[:2].numpy(), np.zeros((2, 3)))

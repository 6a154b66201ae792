"""The port's checkpoint I/O (``utils/checkpoint.py``, flax's msgpack layout
written and read without flax or msgpack) against ``flax.serialization``
and the JAX package's ``save_pytree``/``load_pytree``, both ways, and the
committed ``models/pinc_best.msgpack`` loaded by both packages.

Tolerances: arrays round-trip bit for bit, and a tree written by either
package gives the same bytes.  The committed network's forward at float64
agrees to atol 1e-12 on outputs up to ~20 (measured 1.3e-15); at explicit
float32 to atol 1e-5 (measured 9.5e-7).
"""

import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from bluerov2_dynamics_tpu.models import pinc as jpinc
from bluerov2_dynamics_tpu.utils import checkpoint as jck
from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.models import pinc as tpinc
from bluerov2_dynamics_tpu_torch.utils import checkpoint as tck

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "pinc_best.msgpack"


def _tree(rng):
    return {
        "params": {"Dense_0": {"kernel": rng.normal(size=(14, 8)).astype(np.float32),
                               "bias": np.zeros(8, np.float32)},
                   "AdaptiveSoftplus_0": {"beta": np.asarray(1.5, np.float32)}},
        "norm_mu": rng.normal(size=14),
        "counts": np.arange(-3, 300, dtype=np.int64),
        "flags": np.array([True, False]),
        "scalar": np.float32(2.5),
        "ints": {"small": 7, "neg": -40, "big": 70_000, "huge": -(2 ** 40)},
        "misc": {"f": 0.125, "s": "x" * 40, "none": None, "t": True, "b": b"\x00\x01"},
        "seq": (np.zeros(3), 4),
        "empty": np.zeros((0, 5), np.float32),
    }


def _equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (a, b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_bytes_equal_flax_to_bytes(rng):
    tree = _tree(rng)
    assert tck.to_bytes(tree) == serialization.to_bytes(tree)


def test_port_file_loads_in_flax_and_the_jax_package(tmp_path, rng):
    tree = _tree(rng)
    path = tmp_path / "port.msgpack"
    tck.save_pytree(path, tree)
    restored = serialization.msgpack_restore(path.read_bytes())
    _equal(restored["params"], tree["params"])
    _equal(restored["counts"], tree["counts"])
    assert restored["seq"]["1"] == 4 and restored["misc"]["s"] == "x" * 40
    like = {"params": jax.tree.map(lambda a: np.zeros_like(a), tree["params"]),
            "norm_mu": np.zeros(14)}
    path2 = tmp_path / "port2.msgpack"
    tck.save_pytree(path2, {"params": tree["params"], "norm_mu": tree["norm_mu"]})
    got = jck.load_pytree(path2, like)
    _equal(jax.tree.map(np.asarray, got), {"params": tree["params"], "norm_mu": tree["norm_mu"]})


def test_jax_package_file_loads_in_the_port(tmp_path, rng):
    tree = {"params": _tree(rng)["params"], "norm_mu": rng.normal(size=14),
            "norm_sigma": rng.random(14)}
    jck.save_pytree(tmp_path / "jax.msgpack", jax.tree.map(jnp.asarray, tree))
    tck.save_pytree(tmp_path / "port.msgpack", tree)
    # the JAX package's save_pytree sorts every map's keys (its jax.tree.map): so does the port's
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    got = tck.load_pytree(tmp_path / "jax.msgpack", {"params": None, "norm_mu": None,
                                                      "norm_sigma": None})
    _equal(got, tree)
    data = serialization.to_bytes(_tree(rng))
    _equal(tck.from_bytes(data), serialization.msgpack_restore(data))


def test_chunked_arrays_torch_tensors_and_errors(tmp_path, monkeypatch, rng):
    big = rng.normal(size=(6, 7))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)     # flax chunks above it
    data = serialization.to_bytes({"big": big, "small": np.ones(2)})
    assert b"__msgpack_chunked_array__" in data
    got = tck.from_bytes(data)
    np.testing.assert_array_equal(got["big"], big)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    _equal(tck.from_bytes(tck.to_bytes({"t": t})), {"t": t.numpy()})
    with pytest.raises(ValueError, match="truncated"):
        tck.from_bytes(tck.to_bytes({"a": np.ones(3)})[:-2])
    tck.save_pytree(tmp_path / "a.msgpack", {"a": np.ones(3)})
    with pytest.raises(ValueError, match="missing"):
        tck.load_pytree(tmp_path / "a.msgpack", {"a": None, "b": None})
    with pytest.raises(TypeError):
        tck.to_bytes({"x": object()})


def test_committed_checkpoint_loads_in_both_packages_with_equal_forwards(rng):
    meta = json.loads((REPO / "models" / "pinc_best.msgpack.json").read_text())
    assert meta["position_invariant"] and meta["normalize"] and meta["hidden"] == [64, 64, 64, 64]
    tree = tck.load_pytree(CKPT)
    assert tck.to_bytes(tree) == CKPT.read_bytes()          # the same bytes back
    _, params0 = jpinc.init_params(jax.random.PRNGKey(1), tuple(meta["hidden"]))
    jtree = jck.load_pytree(CKPT, {"params": params0, "norm_mu": np.zeros(14),
                                   "norm_sigma": np.ones(14)})
    _equal(tree, jax.tree.map(np.asarray, jtree))
    assert tree["norm_mu"].dtype == np.float64
    jnet, _ = jpinc.init_params(jax.random.PRNGKey(1), tuple(meta["hidden"]),
                                norm_mu=jtree["norm_mu"], norm_sigma=jtree["norm_sigma"],
                                position_invariant=True)
    tnet = convert.pinc_params_from_numpy(tree["params"], tree["norm_mu"], tree["norm_sigma"],
                                          meta["hidden"], position_invariant=True, device="cpu")
    z = rng.normal(size=(300, 14)) * np.r_[[5.0] * 3, [1.0] * 11]
    psi = rng.uniform(-np.pi, np.pi, 300)
    z[:, 3], z[:, 4], z[:, 13] = np.cos(psi), np.sin(psi), 0.02
    for dtype, tdtype, atol in ((np.float64, torch.float64, 1e-12),
                                (np.float32, torch.float32, 1e-5)):
        want = np.asarray(jnet.apply(jtree["params"], jnp.asarray(z, dtype)))
        got = tnet.to(tdtype)(torch.as_tensor(z, dtype=tdtype)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # and it writes back the committed bytes
    back = {"params": convert.pinc_params_to_numpy(tnet.float()),
            "norm_mu": tnet.norm_mu, "norm_sigma": tnet.norm_sigma}
    assert tck.to_bytes(tck._sorted(back)) == CKPT.read_bytes()


def test_port_trained_checkpoint_loads_in_the_jax_package(tmp_path, rng):
    net = tpinc.init_params(torch.Generator().manual_seed(0), (16, 16),
                            norm_mu=rng.normal(size=14), norm_sigma=1 + rng.random(14),
                            position_invariant=True)
    path = tmp_path / "ck.msgpack"
    tck.save_pytree(path, {"params": convert.pinc_params_to_numpy(net),
                           "norm_mu": net.norm_mu, "norm_sigma": net.norm_sigma})
    _, params0 = jpinc.init_params(jax.random.PRNGKey(0), (16, 16))
    jtree = jck.load_pytree(path, {"params": params0, "norm_mu": np.zeros(14),
                                   "norm_sigma": np.ones(14)})
    jnet, _ = jpinc.init_params(jax.random.PRNGKey(0), (16, 16), norm_mu=jtree["norm_mu"],
                                norm_sigma=jtree["norm_sigma"], position_invariant=True)
    z = rng.normal(size=(50, 14)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jnet.apply(jtree["params"], jnp.asarray(z))),
                               net(torch.from_numpy(z)).detach().numpy(), rtol=0, atol=1e-5)

"""The port's profiling helpers (``utils/profiling.py``) against the JAX
package's on the same nested structures: ``check_finite`` names the same
leaf with the same path string (``jax.tree_util.keystr``), and
``fraction_nonfinite`` gives the same fraction (exact: both count
elements).  ``trace`` writes a Chrome trace; ``StepsPerSecond`` reads the
clock after the result."""

import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu.utils import profiling as jprof
from bluerov2_dynamics_tpu_torch.utils import profiling as tprof


class Pair(NamedTuple):
    first: object
    second: object


def _tree(to, bad=None):
    """A nested dict/list/tuple/NamedTuple of arrays; ``bad`` names the leaf
    that gets a non-finite value."""
    leaves = {
        "w": np.arange(6.0).reshape(2, 3), "b": np.ones(3), "k": np.arange(4),
        "x0": np.zeros(2), "x1": np.full(3, 2.0), "p": np.linspace(0, 1, 5), "s": np.ones(2),
    }
    if bad is not None:
        leaves[bad] = leaves[bad].astype(float)
        leaves[bad].flat[-1] = {"w": np.nan, "x1": np.inf}.get(bad, -np.inf)
    c = {k: to(v) for k, v in leaves.items()}
    return {"zeta": {"w": c["w"], "b": c["b"]}, "alpha": [c["x0"], (c["x1"], None)],
            "mid": Pair(first=c["p"], second={"s": c["s"], "k": c["k"]})}


@pytest.mark.parametrize("bad", [None, "w", "x1", "p", "s", "b"])
def test_check_finite_names_the_leaf_as_keystr_does(bad):
    import jax.numpy as jnp

    def message(mod, tree):
        try:
            mod.check_finite(tree, name="params")
        except FloatingPointError as e:
            return str(e)
        return None

    got = message(tprof, _tree(torch.as_tensor, bad))
    want = message(jprof, _tree(jnp.asarray, bad))
    assert got == want
    assert (got is None) == (bad is None)
    # numpy leaves name the same path
    assert message(tprof, _tree(np.asarray, bad)) == want


def test_the_first_bad_leaf_follows_sorted_keys():
    import jax.numpy as jnp

    def tree(to):
        t = _tree(to)
        t["zeta"]["b"] = to(np.array([np.nan]))
        t["alpha"][0] = to(np.array([np.inf]))
        return t

    with pytest.raises(FloatingPointError) as e:
        tprof.check_finite(tree(torch.as_tensor), "t")
    with pytest.raises(FloatingPointError) as f:
        jprof.check_finite(tree(jnp.asarray), "t")
    assert str(e.value) == str(f.value) == "non-finite values in t['alpha'][0]"


def test_fraction_nonfinite_matches_jax():
    import jax.numpy as jnp

    for bad in (None, "w", "x1"):
        assert tprof.fraction_nonfinite(_tree(torch.as_tensor, bad)) == \
            jprof.fraction_nonfinite(_tree(jnp.asarray, bad))
    assert tprof.fraction_nonfinite(_tree(torch.as_tensor, "w")) == 1 / 25
    assert tprof.fraction_nonfinite({}) == jprof.fraction_nonfinite({}) == 0.0


def test_trace_writes_a_chrome_trace_and_steps_per_second_reads_after(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with tprof.StepsPerSecond(100) as c:
        out = c.done({"y": y, "n": [y.sum()]})
    assert out["y"] is y and c.rate > 0

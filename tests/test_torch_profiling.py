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

from bluerov2_dynamics_tpu_torch.utils import profiling as tprof


@pytest.fixture(scope="module")
def jprof():
    """The JAX package's helpers, imported here and not with the file, so
    that the card cases below collect on a GPU host without flax (which
    the JAX package's ``utils`` imports)."""
    from bluerov2_dynamics_tpu.utils import profiling

    return profiling


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
def test_check_finite_names_the_leaf_as_keystr_does(jprof, bad):
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


def test_the_first_bad_leaf_follows_sorted_keys(jprof):
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


def test_fraction_nonfinite_matches_jax(jprof):
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


# --- the port's spans (``span``): a shared no-op unless a profiler records


def _span_counts(prof, *names):
    """How many host events of each name the profile holds (a range that
    encloses kernels has a copy on the device's timeline too, not
    counted)."""
    from torch.autograd import DeviceType

    got = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    return [got.count(n) for n in names]


def _euler_record(n, device):
    g = torch.Generator().manual_seed(5)
    X = 0.1 * torch.randn((n, 12), generator=g)
    U = torch.clamp(0.5 * torch.randn((n, 8), generator=g), -1.0, 1.0)
    return X.to(device), U.to(device)


def _quat_record(n, device):
    g = torch.Generator().manual_seed(6)
    X = 0.1 * torch.randn((n, 13), generator=g)
    X[:, 3:7] = torch.nn.functional.normalize(X[:, 3:7] + torch.tensor([1.0, 0, 0, 0]), dim=1)
    return X.to(device), (3.0 * torch.randn((n, 6), generator=g)).to(device)


EVAL_SPANS = ("brov2.evaluate", "brov2.wrapper.launch", "brov2.wrapper.rmse")
FIT_SPANS = ("brov2.sysid.lag_history", "brov2.sysid.capture", "brov2.sysid.replay")


def test_span_is_one_shared_no_op_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert tprof.span("a") is tprof.span("b")
    with tprof.span("a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tprof.span("a") is not tprof.span("b")
        with tprof.span("brov2.test"):
            torch.ones(3).sum()
    assert _span_counts(prof, "brov2.test") == [1]
    assert tprof.span("a") is tprof.span("b")


def test_a_cpu_evaluator_call_is_one_evaluate_span():
    from torch.profiler import ProfilerActivity, profile

    from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator

    X, U = _euler_record(60, "cpu")
    run = fossen_evaluator(0.02, X, U, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(5)
    # the CPU path is the step loop: no launch and no fused epilogue
    assert _span_counts(prof, *EVAL_SPANS) == [1, 0, 0]


def test_a_cpu_fit_is_one_lag_history_span_and_no_graph_spans():
    from torch.profiler import ProfilerActivity, profile

    from bluerov2_dynamics_tpu_torch.models import sysid

    X, U = _euler_record(40, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sysid.fit_thruster(X, U, 0.02, horizon=2, steps=2, device="cpu")
    assert _span_counts(prof, *FIT_SPANS) == [1, 0, 0]


PINC_SPANS = ("brov2.pinc.loss", "brov2.pinc.grad", "brov2.pinc.optim")


def _pinc_epoch():
    """A fresh net, optimiser and 2-minibatch epoch on random pairs; calling
    the result trains it and returns the mean loss and the parameters."""
    from bluerov2_dynamics_tpu_torch.models import params, pinc

    g = torch.Generator().manual_seed(7)
    data = pinc.PINcData(z=torch.randn((60, 14), generator=g), y=torch.randn((60, 9), generator=g),
                         u4=torch.randn((60, 4), generator=g))
    net = pinc.init_params(torch.Generator().manual_seed(8))
    tc = pinc.TrainConfig(batch=8, rollout_windows=2, rollout_steps=3)
    perm, starts = pinc.epoch_draws(g, 60, 2, 8, tc)
    opt = pinc.make_optimizer(tc, net.parameters())
    rp = params.reduced_params(device="cpu")

    def run():
        loss = pinc.train_epoch(net, opt, data, perm, starts, tc, rp, True)
        return loss, [p.detach().clone() for p in net.parameters()]
    return run


def test_a_pinc_epoch_is_three_spans_a_minibatch_and_none_unprofiled(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _pinc_epoch()()
    assert _span_counts(prof, *PINC_SPANS) == [2, 2, 2]
    # with no profiler recording, no span reaches record_function
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name))
    off = _pinc_epoch()()
    assert calls == []
    assert torch.equal(on[0], off[0]) and all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused window kernels and the CUDA-graph fit")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["euler12", "quat13"])
def test_card_evaluator_spans_a_horizon_and_the_same_bits(cuda, state):
    from torch.profiler import ProfilerActivity, profile

    from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import fossen_quat_evaluator

    horizons = (1, 10, 100)
    if state == "euler12":
        run = fossen_evaluator(0.02, *_euler_record(2_000, "cpu"), device=cuda)
    else:
        run = fossen_quat_evaluator(0.02, *_quat_record(2_000, "cpu"), device=cuda)
    off = [run(H).item() for H in horizons]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        on = [run(H).item() for H in horizons]
    assert _span_counts(prof, *EVAL_SPANS) == [3, 3, 3]
    assert np.array(on, dtype=np.float32).tobytes() == np.array(off, dtype=np.float32).tobytes()
    assert np.all(np.isfinite(off))


@pytest.mark.cuda
def test_card_graph_fit_spans_and_the_same_bits(cuda):
    from torch.profiler import ProfilerActivity, profile

    from bluerov2_dynamics_tpu_torch.models import sysid

    X, U = _euler_record(400, cuda)
    kw = dict(horizon=3, steps=4)
    off = sysid.fit_thruster(X, U, 0.02, **kw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        on = sysid.fit_thruster(X, U, 0.02, **kw)
    assert _span_counts(prof, *FIT_SPANS) == [1, 1, 1]
    for a, b in ((off.losses, on.losses), (off.log_scales, on.log_scales)):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(off.losses).all())

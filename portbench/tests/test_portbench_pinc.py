"""The ``pinc-epoch`` cell (kind ``train``) at a tiny size on the CPU, through
the port's ``pinc.train_from_draws``: correct traced and untraced, its
control (the reference in TF32) not correct, planted faults not correct;
its reference, ``reference/pinc.py``, imports nothing of the port and no
JAX; and, on the card at the cell's own size, half of each minibatch not
correct."""

import copy
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, guard, harness, spec
from portbench.tests.test_portbench_guard import _imports

CELL = "pinc-epoch"
SEED = 2**31 + 1234567


def tiny_cell() -> spec.Cell:
    """700 recorded rows of which the first 84 train: 83 pairs, two
    minibatches of 32, two windows of 3 steps; traced on 1 and 2 minibatches;
    the first-updates check on both minibatches."""
    c = spec.cell(spec.load_benchmark(), CELL)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["recording"].update(rows=700, train_split=0.12)
    c.traffic.update(batch=32, rollout_windows=2, rollout_steps=3, trace_steps=[1, 2],
                     output_rows=50, first_steps=2)
    return c


def _run(c, trace=False):
    return harness.run_cell(c, SEED, 0.2, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_epoch_is_correct(trace):
    c = tiny_cell()
    r = _run(c, bool(trace))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == {"loss_first_gap", "param_first_gap", "loss_gap", "param_gap",
                                "output_gap"}
    if trace:
        # off the card no device metric and no span metric reads anything
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {"solve_s", "setup_s"}


def test_control_fails_and_program_passes():
    c = tiny_cell()
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    r = control.readings(c, SEED + 1, 0.1, torch.device("cpu"))
    assert all(r["program"][k] <= limits[k] for k in limits), (r, limits)
    assert any(r["control"][k] > limits[k] for k in limits), (r, limits)


def _plant(mp, fault):
    from bluerov2_dynamics_tpu_torch.models import pinc

    if fault == "step_skipped":
        mp.setattr(pinc.AdamWClip, "step", lambda self, grads: None)
    elif fault == "half_batch":
        orig = pinc.train_epoch
        mp.setattr(pinc, "train_epoch", lambda net, opt, data, perm, *a, **k: orig(
            net, opt, data, perm[:, :perm.shape[1] // 2], *a, **k))
    else:
        orig = pinc.train_from_draws

        def scaled(*a, **k):
            net, history = orig(*a, **k)
            net.forward = lambda z, f=net.forward: 1.05 * f(z)
            return net, [1.05 * h for h in history]
        mp.setattr(pinc, "train_from_draws", scaled)


@pytest.mark.parametrize("fault", ["step_skipped", "half_batch", "answer_scaled"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    r = _run(tiny_cell())
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


def test_reference_imports_nothing_of_the_port_or_jax():
    for mod in _imports(spec.HERE / "reference" / "pinc.py"):
        assert mod.split(".", 1)[0] not in {"bluerov2_dynamics_tpu_torch"} | guard.FORBIDDEN, mod
    code = ("import sys; sys.path[0] = {r!r}; import portbench.reference.pinc; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('bluerov2') "
            "or m.split('.')[0] in {f!r}))").format(r=str(spec.ROOT), f=set(guard.FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stdout + p.stderr


@pytest.mark.cuda
def test_half_batch_at_the_cells_size_is_not_correct(card, monkeypatch):
    """Half of each minibatch at the cell's own size on the card: the first
    updates' checks catch it, where the epoch's chaos leaves its loss and
    parameters near the program's own spread."""
    _plant(monkeypatch, "half_batch")
    c = spec.cell(spec.load_benchmark(), CELL)
    r = harness.run_cell(c, SEED, 0.1, False, card, time.perf_counter())
    print(r["checks"])
    assert r["correct"] is False and r["failed"] > 0, r["checks"]
    for name in ("loss_first_gap", "param_first_gap"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"], r["checks"]

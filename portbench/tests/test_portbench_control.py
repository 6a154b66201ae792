"""What decides ``correct`` is shown to fail: the control (the reference in
TF32 put in the program's place) and planted faults of the timed path."""

import time

import pytest
import torch

from portbench import control, harness, spec
from portbench.tests.tiny import tiny_cell, workloads


@pytest.mark.parametrize("name", workloads())
def test_control_fails_and_program_passes(name):
    c = tiny_cell(name)
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    r = control.readings(c, 2**31 + 3, 0.1, torch.device("cpu"))
    assert all(r["program"][k] <= limits[k] for k in limits), (r, limits)
    assert any(r["control"][k] > limits[k] for k in limits), (r, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", workloads())
def test_control_fails_on_the_card(card, name):
    """At the cell's own size, on three seeds."""
    c = spec.cell(spec.load_benchmark(), name)
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = control.readings(c, seed, 3.0, card)
        assert any(r["control"][k] > limits[k] for k in limits), (seed, r)


def _altered(fn, scale=1.05):
    return lambda *a, **k: fn(*a, **k) * scale


def _plant_score(mp, fault):
    from bluerov2_dynamics_tpu_torch.apps import common
    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.models import fossen

    if fault == "state_unchanged":
        mp.setattr(fossen, "make_thruster_step", lambda *a, **k: (lambda carry, u: carry))
        mp.setattr(fossen, "make_wrench_step", lambda *a, **k: (lambda x, u: x))
    elif fault == "half_batch":
        # the CPU path's evaluators, over the first half of the starts
        for name in ("endpoint_rmse", "endpoint_rmse_carry"):
            orig = getattr(metrics, name)

            def half(step, *a, orig=orig):
                *aux, X, U, H = a
                n = (X.shape[0] - H) // 2
                return orig(step, *aux, X[:n + H], U[:n + H], H)
            mp.setattr(metrics, name, half)
    elif fault == "answer_altered":
        orig = common.endpoint_evaluator_with_kernel
        mp.setattr(common, "endpoint_evaluator_with_kernel",
                   lambda *a, **k: _altered(orig(*a, **k)))


def _plant_rollout(mp, fault):
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout

    orig = cuda_rollout.make_rollout_final_cuda

    def make(*a, **k):
        fn = orig(*a, **k)
        if fault == "state_unchanged":
            return lambda x0, U: x0.clone()
        if fault == "half_batch":
            def half(x0, U):
                out = x0.clone()
                out[: x0.shape[0] // 2] = fn(x0[: x0.shape[0] // 2], U)
                return out
            return half
        return _altered(fn)
    mp.setattr(cuda_rollout, "make_rollout_final_cuda", make)


def _plant_solve(mp, fault):
    from bluerov2_dynamics_tpu_torch.models import sysid

    if fault == "state_unchanged":
        mp.setattr(sysid, "adam_update", lambda *a, **k: None)
    elif fault == "half_batch":
        orig = sysid.fit_thruster
        mp.setattr(sysid, "fit_thruster",
                   lambda X, U, *a, **k: orig(X[: X.shape[0] // 2], U[: U.shape[0] // 2], *a, **k))
    else:
        orig = sysid.fit_thruster
        mp.setattr(sysid, "fit_thruster", lambda *a, **k: (lambda r: r._replace(
            losses=r.losses * 1.05))(orig(*a, **k)))


PLANT = {"score": _plant_score, "rollout": _plant_rollout, "solve": _plant_solve}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", workloads())
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    """The rest of a run, with the timed path broken underneath (no look for
    a chip: the CPU path), comes out not correct."""
    c = tiny_cell(name)
    PLANT[c.traffic["kind"]](monkeypatch, fault)
    r = harness.run_cell(c, 2**31 + 17, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0, r["checks"]

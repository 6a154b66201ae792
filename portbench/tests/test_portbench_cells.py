"""Every cell runs end to end on the CPU at a tiny size, through the port's
plain path, and its answers agree with the reference; a run without a card
fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import tiny_cell, workloads


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", workloads())
def test_cell_runs_on_the_cpu(name, trace):
    c = tiny_cell(name)
    r = harness.run_cell(c, 2**31 + 99, 0.2, bool(trace), torch.device("cpu"), time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for k, v in r["checks"].items():
        assert v["value"] <= v["limit"], k
    if trace:
        # a CPU run reads no device metric: no device events, no card
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(harness.finite(r), allow_nan=False)


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "euler12-score",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_run_without_a_card_fails_and_prints_no_result():
    p = _run(spec.ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "needs 1 CUDA device" in p.stderr


BARE = """
import sys, time, torch
sys.path[0] = '.'
from portbench import harness
from portbench.tests.tiny import tiny_cell
r = harness.run_cell(tiny_cell('euler12-score'), 3, 0.2, False, torch.device('cpu'),
                     time.perf_counter())
print(r)
"""


def test_run_in_a_bare_directory_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: there is no program
    to run, so even the CPU path stops before any result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _run(tmp_path).returncode != 0
    p = subprocess.run([sys.executable, "-c", BARE], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "correct" not in p.stdout
    assert "No module named 'bluerov2_dynamics_tpu_torch'" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", workloads())
def test_cell_on_the_card(card, name):
    """Each cell at its own size, a short window, correct on the card."""
    c = spec.cell(spec.load_benchmark(), name)
    r = harness.run_cell(c, 2**31 + 77, 3.0, False, card, time.perf_counter())
    assert r["correct"] is True, r["checks"]

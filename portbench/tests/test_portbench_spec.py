"""BENCHMARK.json and the files it names parse, keep to the contract's forms,
and are found by name."""

import json
import re
import shutil

import pytest

from portbench import harness, spec
from portbench.tests.tiny import workloads

BENCH = spec.load_benchmark()
LINE = re.compile(r"[^\n\t]{1,200}")


def _name_ok(s):
    return bool(spec.NAME_RE.fullmatch(s))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert _name_ok(entry["name"]) and LINE.fullmatch(entry["why"])
    assert entry["file"].startswith("portbench/configs/")
    cfg = spec.read_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert entry["reduced"] == [] and cfg["state"] in ("euler12", "quat13")
    for key in ("m", "volume", "inertia", "added_mass", "damping_linear", "damping_quadratic",
                "thrusters", "lag", "dt"):
        assert key in cfg


@pytest.mark.parametrize("name", workloads())
def test_cell_files_found_by_name(name):
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert _name_ok(name) and _name_ok(w["traffic"]) and w["chips"] == 1
    assert LINE.fullmatch(w["why"])
    c = spec.cell(BENCH, name)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.limits["checks"]) and all("limit" in v for v in c.limits["checks"].values())


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(m):
    assert _name_ok(m["name"]) and spec.UNIT_RE.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    for w in m.get("workloads", []):
        assert w in workloads()


def test_new_cell_and_metric_are_found_without_edits(tmp_path):
    """A traffic mix, a limits file and a metric reader dropped into a copy
    of the folder are found by their names; no file there is edited."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    traffic = json.loads((base / "traffic" / "score.json").read_text())
    traffic["horizons"] = [100]
    traffic["recording"]["part"] = "all"
    (base / "traffic" / "score-session.json").write_text(json.dumps(traffic))
    (base / "limits" / "euler12-score-session.json").write_text(
        (base / "limits" / "euler12-score.json").read_text())
    (base / "metrics" / "requests_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace['requests'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "euler12-score-session", "config": "bluerov2-heavy-euler12",
                               "traffic": "score-session", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "wrapper",
                               "moves": "score_ms", "workloads": ["euler12-score-session"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("score_ms", "score_ms_p95"):
            m["workloads"].append("euler12-score-session")
    c = spec.cell(bench, "euler12-score-session", base=base)
    assert c.traffic["horizons"] == [100] and c.traffic["recording"]["part"] == "all"
    assert "requests_traced" in {m["name"] for m in c.per_layer}
    assert harness.read_metric("requests_traced", type("C", (), {"trace": {"requests": 3}}),
                               base=base) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before

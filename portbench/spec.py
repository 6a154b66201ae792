"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose ``file`` is
given in ``configs``, and a traffic mix, read from ``traffic/<traffic>.json``.
Its comparison's limits are ``limits/<cell>.json``, and each per-layer metric
is read by ``metrics/<metric>.py``.  Adding a cell, a configuration, a
traffic mix or a metric is adding files and entries; no file here changes.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list         # entries of per_layer this cell reports
    limits: dict


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(entry: dict, cell: str, e2e_names) -> bool:
    """Whether a metric entry is reported in ``cell``: it lists the cell, or
    lists no cells and (per-layer) moves a metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(base.parent / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=read_json(base / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=read_json(base / "limits" / f"{name}.json"))

"""Cells cut to sizes the CPU tests can hold: the same traffic files with
their sizes overridden, never edited."""

from __future__ import annotations

import copy

from portbench import spec

CUTS = {
    "score": lambda t: (t["recording"].update(rows=1500), t.update(horizons=[1, 10],
                                                                   trace_requests=3)),
    "rollout": lambda t: (t.update(batch=64, steps=20, trace_requests=2),
                          t["check"].update(rows=16, among_first=5, calls=2)),
    "solve": lambda t: (t["recording"].update(rows=700), t.update(steps=4)),
}


def tiny_cell(name: str) -> spec.Cell:
    c = spec.cell(spec.load_benchmark(), name)
    c.traffic = copy.deepcopy(c.traffic)
    CUTS[c.traffic["kind"]](c.traffic)
    return c


def workloads():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]

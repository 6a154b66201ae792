"""One run of one cell: set-up, the measured window, the comparison, the line.

``run_cell`` drives a cell on a device it is handed; :func:`main` is the
command line, which refuses to run without the chips the cell asks for and
prints the result as the last line of standard output, with the numbers
compared beside their limits as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from types import SimpleNamespace

import torch

from portbench import guard, kinds, spec
from portbench.reference import fossen as ref


def read_metric(name: str, ctx, base=spec.HERE):
    """``metrics/<name>.py``'s reading of ``ctx``, or None."""
    path = base / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run ``cell`` once on ``device``; the result's dict (see ``main``)."""
    task = kinds.load(cell.traffic["kind"])(cell.config, cell.traffic, seed, device)
    task.check_params = cell.limits.get("params", {})
    on_card = device.type == "cuda"
    e2e = [m["name"] for m in cell.end_to_end]
    unknown = set(e2e) - set(task.e2e) - {"setup_s"}
    if unknown:
        raise ValueError(f"{cell.name}: kind {cell.traffic['kind']!r} measures no "
                         f"{sorted(unknown)}")

    task.setup()
    setup_s = time.perf_counter() - t_start
    win = task.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    traced = task.trace() if trace else None
    shapes = task.shapes()
    task.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    with ref.strict_float32():
        ref_answers = task.reference_answers(ref.F64)
    rows = task.gaps(task.answers, ref_answers)
    limits = {k: float(v["limit"]) for k, v in cell.limits["checks"].items()}
    checks, failed = {}, 0
    for name, limit in limits.items():
        checks[name] = {"value": max(g[name] for g, _ in rows), "limit": limit}
    for g, count in rows:
        if any(not g[k] <= limits[k] for k in limits):
            failed += count
    correct = bool(rows) and failed == 0 and win["attempted"] > 0

    if not trace:
        values = dict(win["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        ctx = SimpleNamespace(cell=cell.name, cfg=cell.config, traffic=cell.traffic,
                              shapes=shapes, window=win, trace=traced, on_card=on_card)
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": win["attempted"], "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        w = traced["window"]
        dev.update(busy_s=w.busy_s(), window_s=w.window_s)
        result["breakdown"] = {"device_ops": w.device_ops(), "idle_gaps": w.idle_gaps()}
    notes = task.notes()
    if notes:
        result["notes"] = notes
    result["checks"] = checks
    return result


def finite(obj):
    """``obj`` with every non-finite float written as a string (strict JSON)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def card_info(device) -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not readable"
    return f"{torch.cuda.get_device_name(device)}; {out}; torch {torch.__version__}"


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {n}; "
              "no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"portbench: {cell.name} seed {args.seed} on {card_info(device)}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for k, v in result.get("notes", {}).items():
        print(f"note {k}: {v}", file=sys.stderr)
    sys.stdout.write(json.dumps(finite(result)) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0

"""Readings that a cell's limits are set from: the program's and the control's.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... [--seconds 3]

For each seed, one process sets the cell up at its own size, runs a short
window at its own load, and reads each number the comparison holds against
its limit twice: for the program's answers (the lower reading), and for the
control's, the reference put in the program's place and computed in TF32,
the precision below the configuration's float32 with TF32 off (the upper
reading).  Prints one JSON line a seed and a last line with the largest
program reading and the smallest control reading of each number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from portbench import kinds, spec  # noqa: E402
from portbench.reference import fossen as ref  # noqa: E402


def readings(cell: spec.Cell, seed: int, seconds: float, device, control=ref.TF32) -> dict:
    """``{"program": {check: reading}, "control": {...}, "notes": {...}}`` of
    one seed (no control where ``control`` is None); the program's state is
    freed before the references run."""
    task = kinds.load(cell.traffic["kind"])(cell.config, cell.traffic, seed, device)
    task.check_params = cell.limits.get("params", {})
    task.setup()
    task.window(seconds)
    task.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = lambda rows: {k: max(g[k] for g, _ in rows) for k in rows[0][0]}  # noqa: E731
    with ref.strict_float32():
        want = task.reference_answers(ref.F64)
        out = {"program": worst(task.gaps(task.answers, want)), "notes": task.notes()}
        if control is not None:
            ctrl = task.as_answers(task.reference_answers(control))
            out["control"] = worst(task.gaps(ctrl, want))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first this many seeds only (default all)")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    n_ctrl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds, device, ref.TF32 if i < n_ctrl else None)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in r.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds), "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

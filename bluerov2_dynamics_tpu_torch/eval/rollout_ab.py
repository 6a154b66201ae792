"""K1, K3 and K2: this checkout's kernels beside other versions of the same
sources, on one card, in one process.

    python -m bluerov2_dynamics_tpu_torch.eval.rollout_ab --parent DIR
        [--variant LABEL=DIR ...] [--trig-bits] [--no-current] [--out DIR]

``DIR`` holds a ``csrc/`` tree, for example the parent commit's, unpacked
into a directory under ``build/`` with
``git archive <commit> bluerov2_dynamics_tpu_torch/csrc | tar -x -C build/parent``;
``--variant`` adds more trees (for example this checkout's ``csrc/`` with
one constant changed, to time one lever alone).  A tree may hold any of
the kernels.  K1 is ``rollout.cu``; K3 is ``batched_rollout.cu``, or in an
older tree the per-trajectory instantiation of ``window_eval.cu``; K2 is
``window_eval.cu``'s ``brov2_window_eval``.  Each source is compiled with
this checkout's nvcc flags into ``build/ab_kernels/<label>/``, all
together.  The launcher's parameters are read from the source, and a tree
whose launcher takes other parameters than this checkout's is refused.
Where a source exports no occupancy query, a shim adds one at the block
size its ``kThreads`` gives.

For each kernel it prints ptxas's registers, stack frame and spills, the
resident blocks per SM at the launched block size, and the opcode counts
of the step loop from ``cuobjdump -sass`` (the listings, gzipped, and
``rows.json`` go to ``--out``).  Then it times the kernels with CUDA
events, in turns (the trees, current, current, the trees again) on the
same inputs: K1 and K3 at B = 65,536 x T = 500 RK4, K2 at 9,065 and 44,800
starts x H = 100 Euler with the lag.  Every tree's kernels, this
checkout's too, are launched through their C entry points with the same
arguments, so no Python wrapper's host time falls between the timed
launches.  It prints the largest difference of each output from the first
tree's.  ``--trig-bits`` holds ``sincosf``
against ``sinf``/``cosf`` over every float32.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from bluerov2_dynamics_tpu_torch.ops import _build

B, T, DT = 65_536, 500, 0.02
H_WINDOW, WINDOW_STARTS = 100, (9_065, 44_800)
AB_DIR = _build.BUILD_DIR.parent / "ab_kernels"
_P, _I = ctypes.c_void_p, ctypes.c_int


# name: (this checkout's library, launcher, occupancy query, its leading int
# arguments, candidate sources as (file, kernel instantiation, a text the
# source must hold), shapes timed).  K2's query also takes the kernel form
# (0: the endpoints); that instantiation is window_eval_kernel<0, true, false>.
KERNELS = {
    "rollout_final": ("rollout", "brov2_rollout_final", "brov2_rollout_occupancy", 1,
                      (("rollout.cu", "rollout_kernel<1>", "rollout_kernel"),), (B,)),
    "batched_rollout": ("batched_rollout", "brov2_batched_rollout",
                        "brov2_batched_rollout_occupancy", 2,
                        (("batched_rollout.cu", "batched_rollout_kernel<1, true>",
                          "batched_rollout_kernel"),
                         ("window_eval.cu", "window_eval_kernel<1, true, true>", "PER_TRAJ")),
                        (B,)),
    "window_eval": ("window_eval", "brov2_window_eval", "brov2_window_occupancy", 2,
                    (("window_eval.cu", "window_eval_kernel<0, true, false>", "PER_TRAJ"),
                     ("window_eval.cu", "window_eval_kernel<0, true>", "brov2_window_eval")),
                    WINDOW_STARTS),
}
_SHIM = """#include "{src}"
extern "C" int brov2_ab_occupancy(int* block, int* blocks_per_sm) {{
  *block = {block};
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, {kernel}, {block}, 0));
}}
"""
# Every float32 bit pattern through sinf, cosf and sincosf: counts[0] and
# counts[1] the sines and cosines whose bits differ (two NaNs agree),
# counts[2] the largest distance in units in the last place, counts[3]
# the examples recorded (the first 8 inputs in ex).
_TRIG_BITS = """#include <cstdint>
#include <cuda_runtime.h>
__device__ void note(unsigned long long* counts, unsigned* ex, unsigned i, float a, float b, int k) {
  const unsigned ba = __float_as_uint(a), bb = __float_as_uint(b);
  if (ba == bb || (isnan(a) && isnan(b))) return;
  atomicAdd(&counts[k], 1ull);
  atomicMax(&counts[2], (unsigned long long)(ba > bb ? ba - bb : bb - ba));
  const unsigned long long n = atomicAdd(&counts[3], 1ull);
  if (n < 8) ex[n] = i;
}
__global__ void trig_bits(unsigned long long* counts, unsigned* ex) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < (1ull << 32); i += stride) {
    const float a = __uint_as_float((unsigned)i);
    float s, c;
    sincosf(a, &s, &c);
    note(counts, ex, (unsigned)i, s, sinf(a), 0);
    note(counts, ex, (unsigned)i, c, cosf(a), 1);
  }
}
extern "C" int brov2_trig_bits(unsigned long long* counts, unsigned* ex) {
  trig_bits<<<132 * 16, 256>>>(counts, ex);
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def tree_plan(csrc: Path) -> dict:
    """``{name: (source, kernel, shim block or None)}`` for the kernels the
    tree ``csrc`` holds.  Raises ``ValueError`` on a source whose launcher
    or occupancy query takes other parameters than this checkout's, or that
    neither exports an occupancy query nor states its block size as
    ``kThreads``."""
    plan = {}
    for name, (lib, launcher, occupancy, _, candidates, _) in KERNELS.items():
        for fname, kernel, marker in candidates:
            src = csrc / fname
            text = src.read_text() if src.exists() else ""
            if _n_params(text, launcher) is None or marker not in text:
                continue
            for fn in (launcher, occupancy):
                n, want = _n_params(text, fn), len(_build._SIGNATURES[lib][fn][0])
                if n is not None and n != want:
                    raise ValueError(f"{src}: {fn} takes {n} parameters, this checkout's {want}")
            block = None
            if f"{occupancy}(" not in text:
                k = re.search(r"constexpr int kThreads = (\d+);", text)
                if k is None:
                    raise ValueError(f"{src}: no {occupancy} and no kThreads")
                block = int(k.group(1))
            plan[name] = (src, kernel, block)
            break
    if not plan:
        raise ValueError(f"{csrc}: holds none of the kernels")
    return plan


def _n_params(text: str, fn: str):
    """The number of parameters of the first definition of ``fn`` in
    ``text``, or None where it has none."""
    m = re.search(rf"\b{fn}\(([^)]*)\)", text)
    return None if m is None else len([a for a in m.group(1).split(",") if a.strip()])


def build_trees(trees: dict) -> dict:
    """Compile every kernel source of ``trees`` (``{label: csrc}``), one
    ``nvcc`` each, all together; ``{label: {name: (library, ptxas log,
    path, occupancy)}}``, where ``occupancy()`` gives ``(kernel
    instantiation, block, resident blocks per SM)``."""
    procs = []
    for label, csrc in trees.items():
        into = AB_DIR / label
        into.mkdir(parents=True, exist_ok=True)
        for name, (src, kernel, block) in tree_plan(csrc).items():
            shim = into / f"{name}_shim.cu"
            shim.write_text(f'#include "{src.resolve()}"\n' if block is None else
                            _SHIM.format(src=src.resolve(), kernel=kernel, block=block))
            out = into / f"{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(shim)]
            procs.append((label, name, kernel, block, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {label: {} for label in trees}
    for label, name, kernel, block, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}'s {name}:\n{log}")
        so = ctypes.CDLL(str(out))
        lib, launcher, occupancy, n_int, _, _ = KERNELS[name]
        getattr(so, launcher).argtypes, getattr(so, launcher).restype = \
            _build._SIGNATURES[lib][launcher]
        so.brov2_error_string.argtypes, so.brov2_error_string.restype = [_I], ctypes.c_char_p
        if block is not None:
            query = _shim_query(so, kernel)
        elif name == "window_eval":
            query = _window_query(so)
        else:
            query = _lead_query(so, occupancy, n_int, kernel)
        built[label][name] = (so, log, out, query)
    return built


def _check(so, code: int) -> None:
    _build.check(so, code, "occupancy")


def _shim_query(so, kernel: str):
    so.brov2_ab_occupancy.argtypes, so.brov2_ab_occupancy.restype = [_P, _P], _I

    def query():
        b, per_sm = _I(), _I()
        _check(so, so.brov2_ab_occupancy(ctypes.byref(b), ctypes.byref(per_sm)))
        return kernel, b.value, per_sm.value
    return query


def _lead_query(so, occupancy: str, n_int: int, kernel: str):
    """The source's own query: (method = RK4, [use_lag = 1,] block*, n*)."""
    fn = getattr(so, occupancy)
    fn.argtypes, fn.restype = [_I] * n_int + [_P, _P], _I

    def query():
        b, per_sm = _I(), _I()
        _check(so, fn(*[1] * n_int, ctypes.byref(b), ctypes.byref(per_sm)))
        return kernel, b.value, per_sm.value
    return query


def _window_query(so):
    """K2's query, Euler with the lag, the endpoint form."""
    fn = so.brov2_window_occupancy
    fn.argtypes, fn.restype = _build._SIGNATURES["window_eval"]["brov2_window_occupancy"]

    def query():
        b, per_sm = _I(), _I()
        _check(so, fn(0, 1, 0, ctypes.byref(b), ctypes.byref(per_sm)))
        return "window_eval_kernel<0, true, false>", b.value, per_sm.value
    return query


def trig_bits() -> dict:
    """Bit-for-bit comparison of ``sincosf`` against ``sinf`` and ``cosf``
    over all 2**32 float32 inputs, compiled with this checkout's flags."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    src, out = AB_DIR / "trig_bits.cu", AB_DIR / "trig_bits.so"
    src.write_text(_TRIG_BITS)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(out))
    so.brov2_trig_bits.argtypes, so.brov2_trig_bits.restype = [_P, _P], _I
    so.brov2_error_string.argtypes, so.brov2_error_string.restype = [_I], ctypes.c_char_p
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    ex = torch.zeros(8, dtype=torch.int32, device="cuda")
    _build.check(so, so.brov2_trig_bits(counts.data_ptr(), ex.data_ptr()), "trig_bits")
    torch.cuda.synchronize()
    c = counts.tolist()
    xs = [float(v) for v in ex[:min(8, c[3])].view(torch.float32).tolist()]
    res = dict(sin_differ=c[0], cos_differ=c[1], max_ulp=c[2], examples=xs)
    print(f"sincosf against sinf/cosf over all 2**32 inputs: {json.dumps(res)}")
    return res


def _key(kernel: str) -> str:
    """The mangled-name part of ``rollout_kernel<1>`` or
    ``window_eval_kernel<0, true, 4, false>``."""
    base, _, args = kernel.partition("<")
    parts = [a.strip() for a in args.rstrip(">").split(",") if a.strip()]
    enc = "".join("Lb1E" if a == "true" else "Lb0E" if a == "false" else f"Li{a}E" for a in parts)
    return f"{len(base)}{base}I{enc}E"


def report(label: str, kernel: str, log: str, sass: str | None, block: int,
           blocks_per_sm: int) -> dict:
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp

    key = _key(kernel)
    res = [r for fn, r in _build.ptxas_resources(log).items() if key in fn]
    row = dict(kernel=kernel, block=block, blocks_per_sm=blocks_per_sm,
               resources=res[0] if res else None)
    if sass is not None:
        loop = cp.step_loop(sass, key)
        row.update(step_loop_static=sum(loop["static"].values()),
                   step_loop_fast=dict(sorted(loop["fast"].items(), key=lambda kv: -kv[1])),
                   step_loop_fast_total=sum(loop["fast"].values()))
    print(f"{label}: {json.dumps(row)}")
    return row


def inputs(dev):
    """K1/K3's ``x0``, ``U`` and ``Ub``; K2's ``{n_start: (X, U)}``."""
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = 0.1 * torch.randn((B, 12), generator=g, device=dev)
    U = torch.clamp(0.5 * torch.randn((T, 8), generator=g, device=dev), -1, 1)
    Ub = torch.clamp(0.5 * torch.randn((T, B, 8), generator=g, device=dev), -1, 1)
    win = {n: (0.1 * torch.randn((n + H_WINDOW, 12), generator=g, device=dev),
               torch.clamp(0.5 * torch.randn((n + H_WINDOW, 8), generator=g, device=dev), -1, 1))
           for n in WINDOW_STARTS}
    return x0, U, Ub, win


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the earlier csrc/ directory")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/rollout_ab"))
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL=DIR",
                    help="another csrc/ directory, timed and reported like --parent")
    ap.add_argument("--trig-bits", action="store_true",
                    help="compare sincosf with sinf and cosf over every float32")
    ap.add_argument("--no-current", action="store_true",
                    help="measure the other trees' kernels only")
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    trees = {"earlier": a.parent}
    for v in a.variant:
        label, _, path = v.partition("=")
        trees[label] = Path(path)
    for csrc in trees.values():
        tree_plan(csrc)          # refuse an unknown tree before touching the card
    if not torch.cuda.is_available():
        sys.exit("rollout_ab: no CUDA device")

    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr

    dev = torch.device("cuda")
    p, cfg, lag = fossen_params(device=dev), thruster_config(device=dev), lag_params(DT, device=dev)
    rc, tc = cr.row_consts(p, DT), cr.thruster_consts(cfg, lag)
    x0, U, Ub, win = inputs(dev)
    built = build_trees(trees)
    tau = cr.launch_tau_seq(tc, U)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(so, name, n):
        if name == "window_eval":
            X, Uw = win[n]
            out = torch.empty((n, 12), device=dev)
            code = so.brov2_window_eval(ctypes.addressof(rc), ctypes.addressof(tc), X.data_ptr(),
                                        Uw.data_ptr(), out.data_ptr(), n, H_WINDOW, 0, 1, stream)
        elif name == "rollout_final":
            out = torch.empty_like(x0)
            code = so.brov2_rollout_final(ctypes.addressof(rc), tau.data_ptr(), x0.data_ptr(),
                                          out.data_ptr(), B, T, 1, stream)
        else:
            out = torch.empty_like(x0)
            code = so.brov2_batched_rollout(ctypes.addressof(rc), ctypes.addressof(tc),
                                            x0.data_ptr(), Ub.data_ptr(), out.data_ptr(), B, T,
                                            1, 1, stream)
        _build.check(so, code, name)
        return out

    a.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    rows, runs = {}, {}
    if a.trig_bits:
        rows["trig_bits"] = trig_bits()
    for label, libs in built.items():
        for name, (so, log, path, query) in libs.items():
            sass = _keep_sass(cp.sass_text(name, path=path), a.out / f"{label}_{name}.sass.gz")
            for n in KERNELS[name][5]:
                kernel, block, per_sm = query()
                rows[f"{label} {name} {n}"] = report(f"{label}_{name}_{n}", kernel, log, sass,
                                                     block, per_sm)
                runs[f"{label} {name} {n}"] = lambda so=so, name=name, n=n: launch(so, name, n)

    labels = list(built)
    if not a.no_current:
        logs = _build.build(("rollout", "batched_rollout", "window_eval"))
        occ = ce.window_occupancy()
        current = {
            "rollout_final": ("rollout_kernel<1>", *cr.rollout_occupancy()),
            "batched_rollout": ("batched_rollout_kernel<1, true>", *ce.batched_rollout_occupancy()),
            "window_eval": ("window_eval_kernel<0, true, false>", occ["block"],
                            occ["blocks_per_sm"]),
        }
        for name, (kernel, block, per_sm) in current.items():
            lib = KERNELS[name][0]
            so = _build.load_library(lib)
            sass = _keep_sass(cp.sass_text(lib), a.out / f"current_{name}.sass.gz")
            for n in KERNELS[name][5]:
                rows[f"current {name} {n}"] = report(f"current_{name}_{n}", kernel, logs[lib],
                                                     sass, block, per_sm)
                # the C launcher, as for the other trees: the Python
                # wrapper's checks would add host time between launches
                runs[f"current {name} {n}"] = lambda so=so, name=name, n=n: launch(so, name, n)
        labels = [*built, "current", "current", *reversed(built)]
    cases = [(name, n) for name in KERNELS for n in KERNELS[name][5]]
    order = [f"{label} {name} {n}" for name, n in cases for label in labels
             if f"{label} {name} {n}" in runs]

    times = {k: [] for k in order}
    for k in order:
        times[k].append(cuda_event_time(runs[k], iters=a.iters))
    for k, v in times.items():
        print(f"time {k}: " + " / ".join(f"{t:.4f}" for t in v) + " ms")
    print("clocks.sm, power.draw, power.limit: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    for name, n in cases:
        have = [label for label in dict.fromkeys(labels) if f"{label} {name} {n}" in runs]
        if len(have) < 2:
            continue
        want = runs[f"{have[0]} {name} {n}"]()
        for label in have[1:]:
            d = float((runs[f"{label} {name} {n}"]() - want).abs().max())
            print(f"max|{label} - {have[0]}| {name} {n}: {d:.3e}")
            rows[f"{label} {name} {n}"][f"max_abs_diff_vs_{have[0]}"] = d
    for k, v in times.items():
        rows[k]["ms"] = v
    (a.out / "rows.json").write_text(json.dumps(rows, indent=1))


def _keep_sass(sass: str | None, path: Path):
    """Write a library's SASS listing, compressed (a window_eval.cu listing
    holds 36 instantiations), and pass it on."""
    if sass is not None:
        path.write_bytes(gzip.compress(sass.encode()))
    return sass



if __name__ == "__main__":
    main()

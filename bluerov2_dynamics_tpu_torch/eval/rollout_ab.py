"""The port's kernels beside other versions of the same sources, on one
card, in one process.

    python -m bluerov2_dynamics_tpu_torch.eval.rollout_ab --parent DIR
        [--variant LABEL=DIR ...] [--tweak LABEL:kName=VALUE[,kName=VALUE...] ...]
        [--kernels NAME,...] [--starts N,...] [--iters N] [--trig-bits]
        [--no-current] [--out DIR]

``DIR`` holds a ``csrc/`` tree, for example the parent commit's, unpacked
into a directory under ``build/`` with
``git archive <commit> bluerov2_dynamics_tpu_torch/csrc | tar -x -C build/parent``;
``--variant`` adds more trees, and ``--tweak`` a copy of this checkout's
``csrc/`` with launch constants changed (``constexpr int`` or ``bool``,
each named once in the tree), to time one lever alone.  A tree may hold
any of the kernels: K1 ``rollout.cu``, with its prologue ``shared_tau``
and the whole ``U -> xT`` sequence as the main path launches it
(``rollout_from_commands``: one C call; in a tree without that entry
point, its ``brov2_tau_seq`` then its ``brov2_rollout_final``); K3
``batched_rollout.cu`` (in an older tree the per-trajectory instantiation of ``window_eval.cu``); K2,
and K4 in its endpoint (``window_eval_wrench``) and fused
(``window_sq_wrench``) forms, ``window_eval.cu``; K5 in both forms
(``window_eval_quat``, ``window_sq_quat``) and K6 ``quat.cu``.  Each
source of each tree is compiled once, with this checkout's nvcc flags,
into ``build/ab_kernels/<label>/``, all together.  The launchers'
parameters are read from the source, and a tree whose launcher or
occupancy query takes other parameters than this checkout's is refused.
Where a source exports no occupancy query for a kernel, a shim adds one
at the block size its constant (``kThreads``, ``kWindowThreads``,
``kRollThreads``) gives.

For each kernel it prints ptxas's registers, stack frame and spills, the
launch plan (K4 and K5: warps a start, block, blocks) and
resident blocks per SM, and the opcode counts of the step loop (of each
warp's loop in a warp-pair kernel) from ``cuobjdump -sass`` (the
listings, gzipped, and ``rows.json`` go to ``--out``).  Then it times the
kernels with CUDA events, in turns (the trees, current, current, the
trees again) on the same inputs: K1, its prologue and sequence, K3 and K6
at B = 65,536 x T = 500 RK4 (the prologue and the sequence also by the
profiler's device time, and the sequence by the host clock, each call
ended by a synchronise, as the main path's caller sees it); the window
kernels at ``--starts`` (9,065 and 44,800) starts x H = 100 Euler (K2 with the lag, K5 renormalised).  Every tree's kernels,
this checkout's too, are launched through their C entry points on
buffers made once, so no Python wrapper's host time falls between the
timed launches.  It prints the largest difference of each output from
the first tree's.  ``--trig-bits`` holds ``sincosf`` against
``sinf``/``cosf`` over every float32.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from bluerov2_dynamics_tpu_torch.ops import _build

B, T, DT = 65_536, 500, 0.02
H_WINDOW, WINDOW_STARTS = 100, (9_065, 44_800)
AB_DIR = _build.BUILD_DIR.parent / "ab_kernels"
CSRC = Path(__file__).resolve().parent.parent / "csrc"
_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclass(frozen=True)
class Kernel:
    """A kernel as this checkout exports it: its library (whose C signatures
    ``_build`` holds), launcher and occupancy query (None: the prologue,
    one block, has none); the candidate sources of a tree as ``(file,
    kernel instantiation, a text the source must hold, the constant that
    states its block size)``; whether it runs at window start counts (else
    at B trajectories)."""

    lib: str
    launcher: str
    query: str
    sources: tuple
    window: bool


SEQUENCE = "rollout_from_commands"
KERNELS = {
    "rollout_final": Kernel("rollout", "brov2_rollout_final", "brov2_rollout_occupancy",
                            (("rollout.cu", "rollout_kernel<1>", "rollout_kernel", "kThreads"),),
                            False),
    "shared_tau": Kernel("rollout", "brov2_tau_seq", None,
                         (("rollout.cu", "tau_seq_kernel", "tau_seq_kernel", None),), False),
    SEQUENCE: Kernel("rollout", "brov2_rollout_from_commands", "brov2_rollout_commands_occupancy",
                     (("rollout.cu", "rollout_commands_kernel<1>", "brov2_rollout_from_commands",
                       "kBlock"),), False),
    "batched_rollout": Kernel(
        "batched_rollout", "brov2_batched_rollout", "brov2_batched_rollout_occupancy",
        (("batched_rollout.cu", "batched_rollout_kernel<1, true>", "batched_rollout_kernel",
          "kThreads"),
         ("window_eval.cu", "window_eval_kernel<1, true, true>", "PER_TRAJ", "kThreads")), False),
    "window_eval": Kernel(
        "window_eval", "brov2_window_eval", "brov2_window_occupancy",
        (("window_eval.cu", "window_eval_kernel<0, true, false>", "PER_TRAJ", "kThreads"),
         ("window_eval.cu", "window_eval_kernel<0, true>", "brov2_window_eval", "kThreads")),
        True),
    "window_eval_wrench": Kernel(
        "window_eval", "brov2_window_eval_wrench", "brov2_window_wrench_occupancy",
        (("window_eval.cu", "window_eval_wrench_kernel<0, false>", "brov2_window_sq_wrench",
          "kThreads"),), True),
    "window_sq_wrench": Kernel(
        "window_eval", "brov2_window_sq_wrench", "brov2_window_wrench_occupancy",
        (("window_eval.cu", "window_eval_wrench_kernel<0, true>", "brov2_window_sq_wrench",
          "kThreads"),), True),
    "window_eval_quat": Kernel(
        "quat", "brov2_window_eval_quat", "brov2_window_quat_occupancy",
        (("quat.cu", "window_eval_quat_kernel<0, true, false>", "brov2_window_sq_quat",
          "kWindowThreads"),), True),
    "window_sq_quat": Kernel(
        "quat", "brov2_window_sq_quat", "brov2_window_quat_occupancy",
        (("quat.cu", "window_eval_quat_kernel<0, true, true>", "brov2_window_sq_quat",
          "kWindowThreads"),), True),
    "rollout_final_quat": Kernel(
        "quat", "brov2_rollout_final_quat", "brov2_rollout_quat_occupancy",
        (("quat.cu", "rollout_quat_kernel<1, true>", "rollout_quat_kernel", "kRollThreads"),),
        False),
}
# The leading int arguments of this checkout's occupancy queries: Euler
# with the lag (K2), RK4 (K1, K3), Euler renormalised (K5); the endpoint
# (0) or fused (1) form; K4's and K5's also take the start count and
# report a plan (cuda_eval.PLAN_FIELDS).
_QUERY_ARGS = {"rollout_final": (1,), SEQUENCE: (1,), "batched_rollout": (1, 1),
               "window_eval": (0, 1, 0), "window_eval_wrench": (0, 0), "window_sq_wrench": (0, 1),
               "window_eval_quat": (0, 1, 0), "window_sq_quat": (0, 1, 1)}
PLAN_QUERIES = ("window_eval_wrench", "window_sq_wrench", "window_eval_quat", "window_sq_quat")
# the instantiation K2's query reports on (the endpoint form)
_QUERIED = {"window_eval": "window_eval_kernel<0, true, false>"}
_SHIM = """extern "C" int brov2_ab_occupancy_{name}(int* block, int* blocks_per_sm) {{
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
    neither exports the occupancy query nor states its block size."""
    plan = {}
    for name, k in KERNELS.items():
        for fname, kernel, marker, block_const in k.sources:
            src = csrc / fname
            text = src.read_text() if src.exists() else ""
            if _n_params(text, k.launcher) is None or marker not in text:
                continue
            for fn in (k.launcher, k.query):
                sig = _build._SIGNATURES[k.lib].get(fn)
                n = None if fn is None else _n_params(text, fn)
                if sig is not None and n is not None and n != len(sig[0]):
                    raise ValueError(f"{src}: {fn} takes {n} parameters, this checkout's "
                                     f"{len(sig[0])}")
            block = None
            if k.query is not None and f"{k.query}(" not in text:
                m = re.search(rf"constexpr int {block_const} = (\d+);", text)
                if m is None:
                    raise ValueError(f"{src}: no {k.query} and no {block_const}")
                block = int(m.group(1))
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


def tweak_tree(label: str, changes: str) -> Path:
    """A tree under ``build/ab_kernels/trees/<label>``: this checkout's
    headers and the sources that ``changes`` (comma-separated
    ``kName=VALUE``) alter, each change set in the one ``constexpr int``
    or ``bool`` that defines it."""
    into = AB_DIR / "trees" / label
    if into.exists():
        shutil.rmtree(into)
    into.mkdir(parents=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, into)
    texts = {f.name: f.read_text() for f in sorted(CSRC.glob("*.cu"))}
    changed = set()
    for change in changes.split(","):
        const, _, value = change.partition("=")
        pat = re.compile(rf"(constexpr (?:int|bool) {re.escape(const.strip())} = )[^;]+;")
        hits = [name for name, text in texts.items() if pat.search(text)]
        if len(hits) != 1 or len(pat.findall(texts[hits[0]])) != 1:
            raise ValueError(f"--tweak {label}: {const} is defined {len(hits)} times")
        texts[hits[0]] = pat.sub(rf"\g<1>{value.strip()};", texts[hits[0]])
        changed.add(hits[0])
    for name in changed:
        (into / name).write_text(texts[name])
    return into


def build_trees(trees: dict) -> dict:
    """Compile every kernel source of ``trees`` (``{label: csrc}``), one
    ``nvcc`` a source, all together; ``{label: {name: (library, ptxas log,
    path, query)}}``, where ``query(n)`` gives ``(kernel instantiation,
    block, resident blocks per SM, plan or None)`` at ``n`` starts."""
    procs = []
    for label, csrc in trees.items():
        into = AB_DIR / label
        into.mkdir(parents=True, exist_ok=True)
        by_source = {}
        for name, (src, kernel, block) in tree_plan(csrc).items():
            by_source.setdefault(src, []).append((name, kernel, block))
        for src, kernels in by_source.items():
            shim = into / f"{src.stem}_shim.cu"
            shim.write_text(f'#include "{src.resolve()}"\n' + "".join(
                _SHIM.format(name=name, kernel=kernel, block=block)
                for name, kernel, block in kernels if block is not None))
            out = into / f"{src.stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(shim)]
            procs.append((label, kernels, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {label: {} for label in trees}
    for label, kernels, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}'s {out.stem}:\n{log}")
        so = ctypes.CDLL(str(out))
        so.brov2_error_string.argtypes, so.brov2_error_string.restype = [_I], ctypes.c_char_p
        for name, kernel, block in kernels:
            k = KERNELS[name]
            fn = getattr(so, k.launcher)
            fn.argtypes, fn.restype = _build._SIGNATURES[k.lib][k.launcher]
            query = (_shim_query(so, name, kernel) if block is not None
                     else _source_query(so, name, kernel) if k.query is not None
                     else lambda n, kernel=kernel: (kernel, 1, None, None))
            built[label][name] = (so, log, out, query)
    return built


def _check(so, code: int) -> None:
    _build.check(so, code, "occupancy")


def _shim_query(so, name: str, kernel: str):
    fn = getattr(so, f"brov2_ab_occupancy_{name}")
    fn.argtypes, fn.restype = [_P, _P], _I

    def query(n):
        b, per_sm = _I(), _I()
        _check(so, fn(ctypes.byref(b), ctypes.byref(per_sm)))
        return kernel, b.value, per_sm.value, None
    return query


def _source_query(so, name: str, kernel: str):
    """The source's own query (``_QUERY_ARGS``).  K4's and K5's report the
    plan at ``n`` starts, and with it which kernel the launcher picks."""
    from bluerov2_dynamics_tpu_torch.ops.cuda_eval import read_plan

    k = KERNELS[name]
    fn = getattr(so, k.query)
    fn.argtypes, fn.restype = _build._SIGNATURES[k.lib][k.query]
    args = _QUERY_ARGS[name]

    def query(n):
        if name in PLAN_QUERIES:
            plan = read_plan(so, k.query, *args, n)
            return pair_kernel(name, plan), plan["block"], plan["blocks_per_sm"], plan
        b, per_sm = _I(), _I()
        _check(so, fn(*args, ctypes.byref(b), ctypes.byref(per_sm)))
        return _QUERIED.get(name, kernel), b.value, per_sm.value, None
    return query


def pair_kernel(name: str, plan: dict) -> str:
    """The instantiation K4's or K5's launcher picks under ``plan`` (Euler,
    K5 renormalised): the warp-pair kernel or the staged one-thread
    kernel."""
    sq = "true" if name.startswith("window_sq") else "false"
    if "wrench" in name:
        form = "pair" if plan["warps"] == 2 else "staged"
        return f"window_{form}_wrench_kernel<0, {sq}>"
    return f"window_staged_quat_kernel<0, true, {sq}>"


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


def mangled_key(kernel: str) -> str:
    """The mangled-name part of ``rollout_kernel<1>`` or
    ``window_eval_kernel<0, true, 4, false>``."""
    base, _, args = kernel.partition("<")
    if not args:
        return f"{len(base)}{base}"
    parts = [a.strip() for a in args.rstrip(">").split(",") if a.strip()]
    enc = "".join("Lb1E" if a == "true" else "Lb0E" if a == "false" else f"Li{a}E" for a in parts)
    return f"{len(base)}{base}I{enc}E"


def loop_counts(sass: str, kernel: str) -> list:
    """The step loops of ``kernel`` (one; a warp-pair kernel's two, the
    kinematic warp's first: it holds the MUFU), each as ``{"warp",
    "static", "fast"}`` with ``cuda_probes.step_loop``'s opcode counts
    (``warp`` is "one", "kinematic" or "dynamic")."""
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp

    key = mangled_key(kernel)
    if kernel.startswith("rollout_commands_kernel"):
        # its chunk loop holds the folded prologue's FFMA as well: the step
        # loop is the innermost loop heaviest in FFMA
        loops = [("one", max(cp.step_loops(sass, key),
                             key=lambda l: sum(n for op, n in l["static"].items()
                                               if op.startswith("FFMA"))))]
    elif "_pair_" not in kernel:
        loops = [("one", cp.step_loop(sass, key))]
    else:
        loops = sorted((("kinematic" if any(op.startswith("MUFU") for op in l["fast"])
                         else "dynamic", l) for l in cp.step_loops(sass, key)),
                       key=lambda wl: wl[0] != "kinematic")
    return [dict(warp=warp, static=dict(l["static"]), fast=dict(l["fast"])) for warp, l in loops]


def report(label: str, kernel: str, log: str, sass: str | None, block: int,
           blocks_per_sm: int, plan: dict | None) -> dict:
    key = mangled_key(kernel)
    res = [r for fn, r in _build.ptxas_resources(log).items() if key in fn]
    row = dict(kernel=kernel, block=block, blocks_per_sm=blocks_per_sm,
               resources=res[0] if res else None, plan=plan)
    if sass is not None and kernel != "tau_seq_kernel":
        row["step_loops"] = [
            dict(warp=l["warp"], static=sum(l["static"].values()),
                 fast=dict(sorted(l["fast"].items(), key=lambda kv: -kv[1])),
                 fast_total=sum(l["fast"].values())) for l in loop_counts(sass, kernel)]
    print(f"{label}: {json.dumps(row)}")
    return row


def inputs(dev, starts, names):
    """The kernels' inputs, made on the card from one seed: ``x0``, ``U``
    and (for K3) ``Ub``; K6's ``xq0``, ``TAUq``; the windows' ``{n: (X12,
    U8, TAU, X13)}``."""
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = 0.1 * torch.randn((B, 12), generator=g, device=dev)
    U = torch.clamp(0.5 * torch.randn((T, 8), generator=g, device=dev), -1, 1)
    Ub = (torch.clamp(0.5 * torch.randn((T, B, 8), generator=g, device=dev), -1, 1)
          if "batched_rollout" in names else None)
    xq0 = 0.1 * torch.randn((B, 13), generator=g, device=dev)
    xq0[:, 3] += 1.0
    TAUq = 3.0 * torch.randn((T, 6), generator=g, device=dev)
    win = {}
    for n in starts:
        X13 = 0.1 * torch.randn((n + H_WINDOW, 13), generator=g, device=dev)
        X13[:, 3] += 1.0
        win[n] = (0.1 * torch.randn((n + H_WINDOW, 12), generator=g, device=dev),
                  torch.clamp(0.5 * torch.randn((n + H_WINDOW, 8), generator=g, device=dev),
                              -1, 1),
                  4.0 * torch.randn((n + H_WINDOW, 6), generator=g, device=dev), X13)
    return x0, U, Ub, xq0, TAUq, win


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the earlier csrc/ directory")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/rollout_ab"))
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL=DIR",
                    help="another csrc/ directory, timed and reported like --parent")
    ap.add_argument("--tweak", action="append", default=[], metavar="LABEL:kName=VALUE,...",
                    help="this checkout's csrc/ with launch constants changed")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to build and time, comma-separated")
    ap.add_argument("--starts", default=",".join(map(str, WINDOW_STARTS)),
                    help="the window kernels' start counts, comma-separated")
    ap.add_argument("--trig-bits", action="store_true",
                    help="compare sincosf with sinf and cosf over every float32")
    ap.add_argument("--no-current", action="store_true",
                    help="measure the other trees' kernels only")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--host-calls", type=int, default=60,
                    help="host-clock calls of the U -> xT sequence a timing (median)")
    a = ap.parse_args(argv)
    names = [n for n in a.kernels.split(",") if n]
    unknown = set(names) - set(KERNELS)
    if unknown:
        raise ValueError(f"--kernels: unknown {sorted(unknown)}")
    starts = tuple(int(n) for n in a.starts.split(",") if n)
    trees = {"earlier": a.parent}
    for v in a.variant:
        label, _, path = v.partition("=")
        trees[label] = Path(path)
    for csrc in trees.values():
        tree_plan(csrc)          # refuse an unknown tree before touching the card
    if not torch.cuda.is_available():
        sys.exit("rollout_ab: no CUDA device")
    for t in a.tweak:
        label, _, changes = t.partition(":")
        trees[label] = tweak_tree(label, changes)
    others = list(trees)
    if not a.no_current:
        trees["current"] = CSRC

    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time, device_ms, host_ms
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr

    dev = torch.device("cuda")
    p, cfg, lag = fossen_params(device=dev), thruster_config(device=dev), lag_params(DT, device=dev)
    rc, tc = cr.row_consts(p, DT), cr.thruster_consts(cfg, lag)
    x0, U, Ub, xq0, TAUq, win = inputs(dev, starts, names)
    built = build_trees(trees)
    tau = cr.launch_tau_seq(tc, U) if "rollout_final" in names else None
    F_scratch = torch.empty((T, 8), device=dev)     # an older brov2_tau_seq's scratch
    stream = torch.cuda.current_stream().cuda_stream
    prc, ptc = ctypes.addressof(rc), ctypes.addressof(tc)
    partials = torch.empty(1 << 16, device=dev)
    ticket = torch.zeros((), dtype=torch.int32, device=dev)

    def launcher(so, name, n):
        """A call that launches ``name`` once on buffers made here, and its
        output."""
        fn = getattr(so, KERNELS[name].launcher)
        if KERNELS[name].window:
            X12, U8, TAU, X13 = win[n]
            quat = "quat" in name
            X = X13 if quat else X12
            fused = name.startswith("window_sq")
            out = torch.empty(() if fused else (n, X.shape[1]), device=dev)
            sq = (out.data_ptr(), partials.data_ptr(), partials.numel(), ticket.data_ptr())
            if name == "window_eval":
                args = (prc, ptc, X12.data_ptr(), U8.data_ptr(), out.data_ptr(), n, H_WINDOW, 0, 1)
            elif fused:
                args = (prc, X.data_ptr(), TAU.data_ptr(), *sq, n, H_WINDOW, 0, *((1,) if quat else ()))
            else:
                args = (prc, X.data_ptr(), TAU.data_ptr(), out.data_ptr(), n, H_WINDOW, 0,
                        *((1,) if quat else ()))
        elif name == "rollout_final":
            out = torch.empty_like(x0)
            args = (prc, tau.data_ptr(), x0.data_ptr(), out.data_ptr(), B, T, 1)
        elif name == "shared_tau":
            out = torch.empty((T, 6), device=dev)
            args = (ptc, U.data_ptr(), F_scratch.data_ptr(), out.data_ptr(), T, 1)
        elif name == SEQUENCE:   # the prologue inside: no tau_seq in device memory
            out = torch.empty_like(x0)
            args = (prc, ptc, U.data_ptr(), x0.data_ptr(), out.data_ptr(), None, B, T, 1, 1)
        elif name == "rollout_final_quat":
            out = torch.empty_like(xq0)
            args = (prc, TAUq.data_ptr(), xq0.data_ptr(), out.data_ptr(), B, T, 1, 1)
        else:
            out = torch.empty_like(x0)
            args = (prc, ptc, x0.data_ptr(), Ub.data_ptr(), out.data_ptr(), B, T, 1, 1)

        def run():
            _build.check(so, fn(*args, stream), name)
            return out
        return run

    def two_launches(so, alloc):
        """A tree's U -> xT sequence without its own entry point: its
        brov2_tau_seq, then its brov2_rollout_final; ``alloc`` makes the
        buffers on every call, as the main path of such a tree did."""
        def buffers():
            return (torch.empty((T, 8), device=dev), torch.empty((T, 6), device=dev),
                    torch.empty_like(x0))
        made = buffers()

        def run():
            F, tau_b, out = buffers() if alloc else made
            _build.check(so, so.brov2_tau_seq(ptc, U.data_ptr(), F.data_ptr(), tau_b.data_ptr(),
                                              T, 1, stream), "shared_tau")
            _build.check(so, so.brov2_rollout_final(prc, tau_b.data_ptr(), x0.data_ptr(),
                                                    out.data_ptr(), B, T, 1, stream),
                         "rollout_final")
            return out
        return run

    def main_path(so):
        """The U -> xT call as the main path makes it through its entry
        point: a new xT, one C call."""
        def run():
            out = torch.empty_like(x0)
            _build.check(so, so.brov2_rollout_from_commands(
                prc, ptc, U.data_ptr(), x0.data_ptr(), out.data_ptr(), None, B, T, 1, 1, stream),
                SEQUENCE)
            return out
        return run

    a.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    rows, runs, e2e = {}, {}, {}
    if a.trig_bits:
        rows["trig_bits"] = trig_bits()
    for label, libs in built.items():
        sass_of = {}
        for name, (so, log, path, query) in libs.items():
            if name not in names:
                continue
            if path not in sass_of:
                sass_of[path] = _keep_sass(cp.sass_text(name, path=path),
                                           a.out / f"{label}_{path.stem}.sass.gz")
            for n in (starts if KERNELS[name].window else (B,)):
                kernel, block, per_sm, plan = query(n)
                rows[f"{label} {name} {n}"] = report(f"{label}_{name}_{n}", kernel, log,
                                                     sass_of[path], block, per_sm, plan)
                runs[f"{label} {name} {n}"] = launcher(so, name, n)
                if name == SEQUENCE:
                    e2e[f"{label} {name} {n}"] = main_path(so)
        two_launch = {"shared_tau", "rollout_final"} <= set(libs)
        if SEQUENCE in names and SEQUENCE not in libs and two_launch:
            so, log, path, query = libs["rollout_final"]
            kernel, block, per_sm, _ = query(B)
            if path not in sass_of:
                sass_of[path] = _keep_sass(cp.sass_text("rollout", path=path),
                                           a.out / f"{label}_{path.stem}.sass.gz")
            rows[f"{label} {SEQUENCE} {B}"] = report(f"{label}_{SEQUENCE}_{B}", kernel, log,
                                                     sass_of[path], block, per_sm, None)
            rows[f"{label} {SEQUENCE} {B}"]["launches"] = 2
            runs[f"{label} {SEQUENCE} {B}"] = two_launches(so, alloc=False)
            e2e[f"{label} {SEQUENCE} {B}"] = two_launches(so, alloc=True)

    labels = [*others, "current", "current", *reversed(others)] if not a.no_current else others
    cases = [(name, n) for name in names for n in (starts if KERNELS[name].window else (B,))]
    order = [f"{label} {name} {n}" for name, n in cases for label in labels
             if f"{label} {name} {n}" in runs]
    times = {k: [] for k in order}
    dev_times = {k: [] for k in order if k.split()[1] in ("shared_tau", SEQUENCE)}
    host_times = {k: [] for k in order if k in e2e}
    for k in order:
        times[k].append(cuda_event_time(runs[k], iters=a.iters))
        if k in dev_times:
            dev_times[k].append(device_ms(runs[k], calls=a.iters))
        if k in host_times:
            v = sorted(host_ms(e2e[k], calls=a.host_calls))
            host_times[k].append(v[len(v) // 2])
    for k, v in times.items():
        line = f"time {k}: " + " / ".join(f"{t:.4f}" for t in v) + " ms"
        if k in dev_times:
            line += "; profiler device time " + " / ".join(
                "not measured" if t is None else f"{t:.4f}" for t in dev_times[k]) + " ms"
        if k in host_times:
            line += (f"; host clock, median of {a.host_calls} synchronised calls "
                     + " / ".join(f"{t:.4f}" for t in host_times[k]) + " ms")
        print(line)
    print("clocks.sm, power.draw, power.limit: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    for name, n in cases:
        have = [label for label in dict.fromkeys(labels) if f"{label} {name} {n}" in runs]
        if len(have) < 2:
            continue
        want = runs[f"{have[0]} {name} {n}"]().clone()
        for label in have[1:]:
            got = runs[f"{label} {name} {n}"]().clone()
            d = float((got - want).abs().max())
            same = bool(torch.equal(got, runs[f"{label} {name} {n}"]()))
            print(f"max|{label} - {have[0]}| {name} {n}: {d:.3e}"
                  + ("" if same else "  (NOT the same bits on a second launch)"))
            rows[f"{label} {name} {n}"][f"max_abs_diff_vs_{have[0]}"] = d
    for k, v in times.items():
        rows[k]["ms"] = v
        if k in dev_times:
            rows[k]["device_ms"] = dev_times[k]
        if k in host_times:
            rows[k]["host_median_ms"] = host_times[k]
    (a.out / "rows.json").write_text(json.dumps(rows, indent=1))


def _keep_sass(sass: str | None, path: Path):
    """Write a library's SASS listing, compressed, and pass it on."""
    if sass is not None:
        path.write_bytes(gzip.compress(sass.encode()))
    return sass


if __name__ == "__main__":
    main()

"""K8: ceiling probes of the card, as CUDA kernels and their plain PyTorch
versions.

Each probe is the twin of one of the JAX package's ``bench.py`` probes
(``measure_vpu_fma_peak``, ``measure_vpu_transcendental_peak``,
``measure_vpu_fma_tree_peak``, ``measure_quat_mix_peak``) and computes the
same per-lane recurrence on a ``(lanes,)`` float32 tensor; one CUDA thread
runs one lane (``csrc/probes.cu``).  The measured rates price the bounds of
the physics kernels: the FMA-tree rate is the card's FP32 FMA throughput
at full ILP, the sin rate prices an exact ``sinf``, and the quat13 mix rate
is a ceiling in quat13 steps per second that prices its rsqrt and cheap
ops as the card runs them.

* ``launch_*`` launch a kernel on a CUDA tensor (or raise); the
  ``*_plain`` functions are the plain versions, for the tests and for
  ``chip_smoke.py``'s check at small ``iters``.
* ``measure_*`` time a kernel with CUDA events over chained calls,
  renormalising between calls as ``bench.py`` does, and return the rate.
  They raise on the CPU: a rate taken on the host is no device number.
* :func:`sass_loop_counts` reads the built library with ``cuobjdump -sass``
  and counts the instructions of each probe's iteration loop, to show that
  nvcc neither hoisted nor folded a recurrence.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval.op_counts import QUAT_BUDGET
from bluerov2_dynamics_tpu_torch.ops import _build

STREAMS = 8    # independent accumulators of the fma and sin probes
CHAINS = 8     # Horner chains of the tree and mix probes
DEPTH = 64     # Horner depth of the tree probe
LANES = 65_536
CALLS = 3      # chained calls timed per rate
FMA_TREE_FLOPS_PER_ITER = CHAINS * DEPTH * 2 + CHAINS
# bench.py's iterations per call
ITERS = {"fma_peak": 32_768, "transcendental_peak": 8_192, "fma_tree_peak": 8_192,
         "quat_mix_peak": 4_096}
FMA_C, FMA_D = 1.0000001, 1e-9


def _f32(v: float) -> float:
    """``v`` rounded to float32, as ``jnp.float32(v)`` rounds it."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _streams(x):
    return [x * _f32(1.0 + 0.01 * s) for s in range(STREAMS)]


def _sum(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def fma_peak_plain(x, iters: int):
    """``STREAMS`` streams of ``acc <- acc * (c - acc * d)``, then summed."""
    c, d = _f32(FMA_C), _f32(FMA_D)
    accs = _streams(x.to(torch.float32))
    for _ in range(iters):
        accs = [acc * (c - acc * d) for acc in accs]
    return _sum(accs)


def fma_peak_increment(x, y):
    """What the fma probe's iterations added, ``y - fma_peak_plain(x, 0)``,
    in float64.  Each iteration scales a stream by ``c - acc d``, which
    rounds to ``c = 1 + 2**-23``, so ``y`` itself moves by about 1e-7 per
    iteration and a kernel that ran too few iterations would pass a
    relative check of ``y``; the increment moves by ``1 / iters`` of itself
    per iteration."""
    return y.double() - fma_peak_plain(x, 0).double()


def transcendental_peak_plain(x, iters: int):
    """``STREAMS`` streams of ``acc <- sin(acc) + 0.5 acc``, then summed."""
    accs = _streams(x.to(torch.float32))
    for _ in range(iters):
        accs = [torch.sin(acc) + 0.5 * acc for acc in accs]
    return _sum(accs)


def _chains(v, depths):
    ts = []
    for c, depth in enumerate(depths):
        t = v
        k = _f32(0.99 + 0.0001 * c)
        for d in range(depth):
            t = t * k + _f32(1e-3 * (d + 1))
        ts.append(t)
    return ts


def _seed(a, i: int):
    """``a (1 + 1e-7 i)`` with the scalar formed in float32."""
    return a * float(np.float32(1.0) + np.float32(1e-7) * np.float32(i))


def fma_tree_peak_plain(x, iters: int):
    """Per iteration ``CHAINS`` Horner chains of depth ``DEPTH`` from
    ``a (1 + 1e-7 i)``, summed into one accumulator."""
    a = x.to(torch.float32)
    acc = a
    for i in range(iters):
        acc = acc + _sum(_chains(_seed(a, i), [DEPTH] * CHAINS)) * _f32(1e-6)
    return acc


def quat_mix_plan(oc: dict, chains: int = CHAINS) -> dict:
    """The construction of ``bench.py measure_quat_mix_peak`` for an op
    budget ``oc`` (a ``QUAT_BUDGET`` entry): the Horner depth of each chain,
    the rsqrt and division counts, and the cheap-op chain as a list of
    ``(value, op)`` with ``op`` one of ``abs``, ``max``, ``select`` (a
    compare and a select, two ops) and ``neg``."""
    n_rsqrt, n_div, n_cheap = oc["sqrt"], oc["div"], oc["cheap"]
    n_cheap_chains = min(4, n_cheap)
    n_values = chains + n_rsqrt + n_div + n_cheap_chains
    # each Horner step is one fused slot; the seed, rsqrt and division
    # inputs fuse into the accumulate-tree adds, n_values slots in all
    horner = oc["slots"] - oc["cheap"] - n_values
    if horner < chains:
        raise ValueError(f"op budget too small: horner={horner}")
    depths = [horner // chains + (1 if c < horner % chains else 0) for c in range(chains)]
    cheap, emitted, k = [], 0, 0
    while emitted < n_cheap:
        lane, sel = k % n_cheap_chains, k % 3
        if sel == 0:
            cheap.append((lane, "abs"))
            emitted += 1
        elif sel == 1:
            cheap.append((lane, "max"))
            emitted += 1
        elif emitted + 2 <= n_cheap:
            cheap.append((lane, "select"))
            emitted += 2
        else:
            cheap.append((lane, "neg"))
            emitted += 1
        k += 1
    return dict(depths=depths, horner=horner, n_rsqrt=n_rsqrt, n_div=n_div,
                n_cheap_chains=n_cheap_chains, n_values=n_values, cheap=cheap)


def quat_mix_peak_plain(x, iters: int, method: str = "rk4"):
    """Per iteration the op budget of one quat13 ``method`` step
    (``QUAT_BUDGET[method]``) as :func:`quat_mix_plan` lays it out, summed
    into one accumulator."""
    plan = quat_mix_plan(QUAT_BUDGET[method])
    a = x.to(torch.float32)
    acc = a
    for i in range(iters):
        v = _seed(a, i)
        ts = _chains(v, plan["depths"])
        rs = [torch.rsqrt(ts[j % CHAINS] * ts[j % CHAINS]) for j in range(plan["n_rsqrt"])]
        ds = [1.0 / (ts[j % CHAINS] * ts[j % CHAINS]) for j in range(plan["n_div"])]
        us = [ts[k % CHAINS] for k in range(plan["n_cheap_chains"])]
        for lane, op in plan["cheap"]:
            u = us[lane]
            us[lane] = {"abs": torch.abs, "neg": torch.neg,
                        "max": lambda u: torch.clamp_min(u, 0.1),
                        "select": lambda u: torch.where(u < 0.5, u, v)}[op](u)
        acc = acc + _sum(ts + rs + ds + us) * _f32(1e-6)
    return acc


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_ENTRY = {"fma_peak": "brov2_probe_fma", "transcendental_peak": "brov2_probe_sin",
          "fma_tree_peak": "brov2_probe_fma_tree", "quat_mix_peak": "brov2_probe_quat_mix"}
# the ``budget`` argument of ``brov2_probe_quat_mix``: the index of the
# template instantiation of ``quat_mix_kernel`` for each quat13 step
MIX_BUDGET = {"rk4": 0, "euler": 1}


def _launch(name: str, x, iters: int, block: int, *extra):
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (lanes,) float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if iters < 1 or not 32 <= block <= 1024 or block % 32:
        raise ValueError(f"iters={iters} must be >= 1 and block={block} a multiple of 32 "
                         f"in [32, 1024]")
    lib = _build.load_library("probes")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = getattr(lib, _ENTRY[name])(
            x.data_ptr(), y.data_ptr(), x.shape[0], iters, *extra, block,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    _build.launches[name] += 1
    return y


def launch_fma_peak(x, iters: int, block: int = 256):
    return _launch("fma_peak", x, iters, block)


def launch_transcendental_peak(x, iters: int, block: int = 256):
    return _launch("transcendental_peak", x, iters, block)


def launch_fma_tree_peak(x, iters: int, block: int = 256):
    return _launch("fma_tree_peak", x, iters, block)


def launch_quat_mix_peak(x, iters: int, method: str = "rk4", block: int = 256):
    if method not in MIX_BUDGET:
        raise ValueError(f"method must be one of {sorted(MIX_BUDGET)}, got {method!r}")
    return _launch("quat_mix_peak", x, iters, block, MIX_BUDGET[method])


# ---------------------------------------------------------------------------
# Rates
# ---------------------------------------------------------------------------

def _card(device):
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the probes measure a CUDA device, got {device}: a rate "
                           "taken on the host is no device number")
    return device


def _chained_seconds(launch, device, lanes: int) -> float:
    """Seconds per call of ``launch(x)``, chained through ``x`` and
    renormalised to mean magnitude 0.5 between calls, after one warm-up
    call; CUDA events around ``CALLS`` calls."""
    x = torch.full((lanes,), 0.5, dtype=torch.float32, device=device)
    y = launch(x)
    x = y * (0.5 / y.abs().mean())
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        y = launch(x)
        x = y * (0.5 / y.abs().mean())
    end.record()
    end.synchronize()
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("a probe's chained output is not finite")
    return start.elapsed_time(end) / 1e3 / CALLS


def measure_fma_peak(lanes: int = LANES, iters: int = ITERS["fma_peak"],
                     block: int = 256, device=None) -> float:
    """FP32 flops/s of the dependent-stream recurrence (3 flops per
    stream-step)."""
    dev = _card(device)
    secs = _chained_seconds(lambda x: launch_fma_peak(x, iters, block), dev, lanes)
    return 3 * lanes * iters * STREAMS / secs


def measure_transcendental_peak(lanes: int = LANES, iters: int = ITERS["transcendental_peak"],
                                block: int = 256, device=None) -> float:
    """Exact ``sinf`` evaluations per second (the loop's one FFMA per sin
    is not subtracted)."""
    dev = _card(device)
    secs = _chained_seconds(lambda x: launch_transcendental_peak(x, iters, block), dev, lanes)
    return lanes * iters * STREAMS / secs


def measure_fma_tree_peak(lanes: int = LANES, iters: int = ITERS["fma_tree_peak"],
                          block: int = 256, device=None) -> float:
    """FP32 flops/s of the max-ILP Horner tree (``CHAINS * DEPTH * 2 +
    CHAINS`` flops per iteration)."""
    dev = _card(device)
    secs = _chained_seconds(lambda x: launch_fma_tree_peak(x, iters, block), dev, lanes)
    return FMA_TREE_FLOPS_PER_ITER * lanes * iters / secs


def measure_quat_mix_peak(method: str = "rk4", lanes: int = LANES,
                          iters: int = ITERS["quat_mix_peak"], block: int = 256,
                          device=None) -> float:
    """quat13 ``method`` steps/s: one iteration per lane is one step."""
    dev = _card(device)
    secs = _chained_seconds(lambda x: launch_quat_mix_peak(x, iters, method, block), dev, lanes)
    return lanes * iters / secs


# ---------------------------------------------------------------------------
# What nvcc emitted
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_TARGET = re.compile(r"BRA\s+(?:`\(\.L_x_(\d+)\)|(0x[0-9a-f]+))")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")


def _opcode(op: str) -> str:
    return op if op.startswith("MUFU") else op.split(".")[0]


def parse_sass(text: str) -> dict:
    """``{function: {"total": Counter, "loop": Counter}}`` from
    ``cuobjdump -sass`` text.  ``loop`` counts the opcodes of the
    outermost loop: from the earliest backward branch target to the first
    branch that returns there.  MUFU keeps its function (``MUFU.RSQ``);
    other opcodes drop their modifiers."""
    out, name, insns, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        total = Counter(_opcode(op) for _, op, _ in insns)
        backs = []
        for addr, op, args in insns:
            m = _TARGET.search(op + args)
            if m:
                target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
                if target is not None and target <= addr:
                    backs.append((target, addr))
        loop = Counter()
        if backs:
            lo = min(t for t, _ in backs)
            hi = min(a for t, a in backs if t == lo)
            loop = Counter(_opcode(op) for addr, op, _ in insns if lo <= addr <= hi)
        out[name] = {"total": total, "loop": loop}

    pending = []
    for line in text.splitlines():
        f = _FUNC.match(line)
        if f:
            close()
            name, insns, labels, pending = f.group(1), [], {}, []
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    close()
    return out


def sass_loop_counts(name: str = "probes"):
    """:func:`parse_sass` of the built library ``csrc/<name>.cu``, or None
    where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        return None
    _build.build((name,))
    res = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                         text=True, timeout=120, check=True)
    return parse_sass(res.stdout)

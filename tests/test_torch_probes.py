"""K8 (the ceiling probes) and the operation counts that price the bounds.

* The port's copy of the op counts (``eval/op_counts.py``) against the
  JAX package's jaxpr audits (``bench.py``).
* Each probe's plain version against a numpy float32 loop of the
  ``bench.py`` recurrence, at small sizes.
* K8d's construction against ``bench.quat_step_op_counts`` and the
  arithmetic of ``bench.py:290-338``.
* The CUDA kernels against their plain versions, where a card exists.

Tolerances: rtol 1e-6 where the plain version and the numpy loop do the
same float32 operations in the same order; 1e-5 where a library's sin or
rsqrt may differ by an ulp (the sin probe's recurrence damps it), and for
the kernels, where nvcc fuses a multiply and an add into one rounding over
16 dependent steps.  The fma probe's kernel is held by its increment
(``fma_peak_increment``): its output alone moves less than 1e-5 in 16
iterations.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from bluerov2_dynamics_tpu_torch.eval import op_counts
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp

F = np.float32


@pytest.fixture
def lanes(rng):
    return rng.uniform(0.3, 0.7, size=24).astype(np.float32)


# --- the op counts ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_op_counts_are_the_jax_kernels_audits(method):
    step = bench._pallas_kernel_step(method)
    rows = bench._vector_op_buckets(step, tuple(jnp.zeros((8,), jnp.float32) for _ in range(12)),
                                    tuple(jnp.float32(0) for _ in range(6)))
    assert op_counts.ROW_BUDGET[method] == dict(rows, trig=bench.step_trig_count(method))
    assert op_counts.QUAT_BUDGET[method] == bench.quat_step_op_counts(method)
    flops, div, trig = op_counts.ROW_STEP[method]
    assert (flops, div, trig) == (rows["flops"], rows["div"], bench.step_trig_count(method))
    assert op_counts.QUAT_STEP[method] == (op_counts.QUAT_BUDGET[method]["flops"],
                                           op_counts.QUAT_BUDGET[method]["sqrt"])


def test_published_peak_prices_of_a_step():
    """The published-peak pricing of the bounds, unchanged: 16 operations
    per sinf/cosf, 8 per division or rsqrt."""
    assert op_counts.row_ops("rk4") == 684 + 8 * 8 + 16 * 24
    assert op_counts.row_ops("euler") == 156 + 8 * 2 + 16 * 6
    assert op_counts.quat_ops("rk4") == 877 + 8 * 5
    assert op_counts.quat_ops("euler") == 212 + 8 * 2
    assert op_counts.actuation_ops(24) == 8 * 36 + 42


# --- the plain probes against numpy loops of bench.py's recurrences -----------------

def _np_streams(x):
    return [x * F(1.0 + 0.01 * i) for i in range(8)]


def _np_sum(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def test_fma_peak_plain_matches_numpy(lanes):
    c, d = F(1.0000001), F(1e-9)
    accs = _np_streams(lanes)
    for _ in range(40):
        accs = [acc * (c - acc * d) for acc in accs]
    got = cp.fma_peak_plain(torch.from_numpy(lanes), 40)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np_sum(accs), rtol=1e-6)


def test_transcendental_peak_plain_matches_numpy(lanes):
    accs = _np_streams(lanes)
    for _ in range(30):
        accs = [np.sin(acc) + F(0.5) * acc for acc in accs]
    got = cp.transcendental_peak_plain(torch.from_numpy(lanes), 30)
    np.testing.assert_allclose(got.numpy(), _np_sum(accs), rtol=1e-5)


def _np_tree_iter(a, i, depths):
    v = a * (F(1.0) + F(1e-7) * F(i))
    ts = []
    for c, depth in enumerate(depths):
        t = v
        for dd in range(depth):
            t = t * F(0.99 + 0.0001 * c) + F(1e-3 * (dd + 1))
        ts.append(t)
    return v, ts


def test_fma_tree_peak_plain_matches_numpy(lanes):
    acc = lanes
    for i in range(6):
        _, ts = _np_tree_iter(lanes, i, [64] * 8)
        acc = acc + _np_sum(ts) * F(1e-6)
    got = cp.fma_tree_peak_plain(torch.from_numpy(lanes), 6)
    np.testing.assert_allclose(got.numpy(), acc, rtol=1e-6)
    assert cp.FMA_TREE_FLOPS_PER_ITER == 8 * 64 * 2 + 8


def _np_quat_mix(a, iters, oc):
    """bench.py:290-338 (measure_quat_mix_peak's body_math) in numpy."""
    chains = 8
    n_rsqrt, n_div, n_cheap = oc["sqrt"], oc["div"], oc["cheap"]
    n_cheap_chains = min(4, n_cheap)
    n_values = chains + n_rsqrt + n_div + n_cheap_chains
    horner = oc["slots"] - oc["cheap"] - n_values
    depths = [horner // chains + (1 if c < horner % chains else 0) for c in range(chains)]
    acc = a
    for i in range(iters):
        v, ts = _np_tree_iter(a, i, depths)
        rs = [F(1.0) / np.sqrt(ts[j % chains] * ts[j % chains]) for j in range(n_rsqrt)]
        ds = [F(1.0) / (ts[j % chains] * ts[j % chains]) for j in range(n_div)]
        us = [ts[k % chains] for k in range(n_cheap_chains)]
        emitted = k = 0
        while emitted < n_cheap:
            lane, sel = k % n_cheap_chains, k % 3
            if sel == 0:
                us[lane] = np.abs(us[lane])
                emitted += 1
            elif sel == 1:
                us[lane] = np.maximum(us[lane], F(0.1))
                emitted += 1
            elif emitted + 2 <= n_cheap:
                us[lane] = np.where(us[lane] < F(0.5), us[lane], v)
                emitted += 2
            else:
                us[lane] = -us[lane]
                emitted += 1
            k += 1
        acc = acc + _np_sum(ts + rs + ds + us) * F(1e-6)
    return acc


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_quat_mix_peak_plain_matches_numpy(method, lanes):
    got = cp.quat_mix_peak_plain(torch.from_numpy(lanes), 5, method)
    np.testing.assert_allclose(got.numpy(), _np_quat_mix(lanes, 5, op_counts.QUAT_BUDGET[method]),
                               rtol=1e-6)


@pytest.mark.parametrize("method,depths", [("rk4", [65] + [64] * 7),
                                           ("euler", [15] * 6 + [14] * 2)])
def test_quat_mix_plan_is_bench_construction(method, depths):
    """Horner depths from ``slots - cheap - n_values``, then the rsqrt,
    division and cheap counts of the audited step."""
    oc = bench.quat_step_op_counts(method)
    plan = cp.quat_mix_plan(oc)
    n_values = 8 + oc["sqrt"] + oc["div"] + min(4, oc["cheap"])
    assert plan["n_values"] == n_values
    assert plan["horner"] == sum(plan["depths"]) == oc["slots"] - oc["cheap"] - n_values
    assert plan["depths"] == depths
    assert (plan["n_rsqrt"], plan["n_div"]) == (oc["sqrt"], oc["div"])
    cheap = sum(2 if op == "select" else 1 for _, op in plan["cheap"])
    assert cheap == oc["cheap"]
    assert plan["horner"] + plan["n_values"] + cheap == oc["slots"]
    # the instantiations of csrc/probes.cu: <HORNER, N_RSQRT, N_CHEAP>
    assert (plan["horner"], plan["n_rsqrt"], oc["cheap"]) == {
        "rk4": (513, 5, 47), "euler": (118, 2, 14)}[method]


def test_quat_mix_budgets_map_to_their_kernel_instantiations():
    """``MIX_BUDGET[method]`` selects, in ``brov2_probe_quat_mix``, the
    ``quat_mix_kernel<HORNER, N_RSQRT, N_CHEAP>`` of that method's plan."""
    src = (Path(cp.__file__).parents[1] / "csrc" / "probes.cu").read_text()
    built = {int(b): tuple(int(v) for v in args) for b, *args in re.findall(
        r"budget == (\d+)\) return launch\(quat_mix_kernel<(\d+), (\d+), (\d+)>", src)}
    assert sorted(built) == sorted(cp.MIX_BUDGET.values())
    for method, index in cp.MIX_BUDGET.items():
        plan = cp.quat_mix_plan(op_counts.QUAT_BUDGET[method])
        assert built[index] == (plan["horner"], plan["n_rsqrt"],
                                op_counts.QUAT_BUDGET[method]["cheap"])
    with pytest.raises(ValueError, match="method"):
        cp.launch_quat_mix_peak(torch.full((64,), 0.5), 4, "midpoint")
    with pytest.raises(ValueError, match="too small"):
        cp.quat_mix_plan(dict(flops=0, div=0, sqrt=1, cheap=1, slots=10))


def test_fma_peak_increment_sees_one_iteration(lanes):
    """The fma probe's output moves by ~1e-7 per iteration, below the
    check's rtol 1e-5 on every lane, so the check compares the increment,
    which one iteration more or less moves far outside the tolerance on
    some lane (on others the float32 sum of the streams rounds it away)."""
    x = torch.from_numpy(lanes)
    y16, y15 = cp.fma_peak_plain(x, 16), cp.fma_peak_plain(x, 15)
    assert float(((y16 - y15) / y16).abs().max()) < 1e-5
    i16, i15 = cp.fma_peak_increment(x, y16), cp.fma_peak_increment(x, y15)
    assert float(((i16 - i15) / i16).abs().max()) > 100 * 1e-5
    assert torch.equal(cp.fma_peak_increment(x, cp.fma_peak_plain(x, 0)),
                       torch.zeros(len(lanes), dtype=torch.float64))


# --- the wrappers off the card ------------------------------------------------------

def test_probes_refuse_the_host():
    x = torch.full((64,), 0.5)
    for launch in (cp.launch_fma_peak, cp.launch_transcendental_peak, cp.launch_fma_tree_peak,
                   cp.launch_quat_mix_peak):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(x, 4)
    for measure in (cp.measure_fma_peak, cp.measure_transcendental_peak,
                    cp.measure_fma_tree_peak, cp.measure_quat_mix_peak):
        with pytest.raises(RuntimeError, match="no device number"):
            measure(device="cpu")


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115fma_tree_kernelEPKfPfii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   FFMA.FTZ R2, R2, R4, R5 ;
        /*0030*/                   MUFU.RSQ R6, R2 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   FADD R7, R2, R6 ;
        /*0060*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_115sin_peak_kernelEPKfPfii
        /*0000*/                   FMUL R1, R2, R3 ;
        /*0010*/                   BRA `(.L_x_0) ;
.L_x_1:
        /*0020*/                   FFMA R1, R1, R2, R3 ;
.L_x_0:
        /*0030*/               @P1 BRA `(.L_x_1) ;
        /*0040*/                   EXIT ;
"""


def test_parse_sass_counts_the_outer_loop():
    got = cp.parse_sass(SASS)
    tree = got["_ZN12_GLOBAL__N_115fma_tree_kernelEPKfPfii"]
    assert tree["total"]["FFMA"] == 2 and tree["total"]["MUFU.RSQ"] == 1
    assert tree["loop"] == {"FFMA": 2, "MUFU.RSQ": 1, "BRA": 1}
    sin = got["_ZN12_GLOBAL__N_115sin_peak_kernelEPKfPfii"]
    assert sin["loop"] == {"FFMA": 1, "BRA": 1}
    assert sin["total"]["BRA"] == 2


STEP_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_114rollout_kernelILi1EEEv9RowConstsPKfS3_Pfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS.64 R2, [R4] ;
        /*0030*/                   FMUL R0, R5, 0.63661974668502807617 ;
        /*0040*/                   FSETP.GE.AND P0, PT, |R5|, 105615, PT ;
        /*0050*/                   FFMA R6, R0, R7, R8 ;
        /*0060*/               @!P0 BRA 0xb0 ;
        /*0070*/                   LDG.E.CONSTANT R9, desc[UR6][R10.64] ;
        /*0080*/                   STL [R1], R9 ;
        /*0090*/                @P1 BRA 0x70 ;
        /*00a0*/                   DMUL R2, R2, UR4 ;
        /*00b0*/                   FFMA R6, R6, R7, R8 ;
        /*00c0*/               @!P2 BRA 0xf0 ;
        /*00d0*/                   CALL.REL.NOINC 0x200 ;
        /*00e0*/                   MOV R3, R4 ;
        /*00f0*/                   FFMA R6, R6, R2, R8 ;
        /*0100*/                @P3 BRA 0x20 ;
        /*0110*/                @P4 BRA 0x10 ;
        /*0120*/                   EXIT ;
"""


def test_step_loop_counts_the_common_path():
    """The step loop is the smallest loop with 90% of the FFMA (not the
    chunk loop around it), and its common path leaves out the regions a
    thread jumps over that hold a loop or a call."""
    got = cp.step_loop(STEP_SASS, "14rollout_kernelILi1E")
    assert got["window"] == (0x20, 0x100)
    assert got["static"]["FFMA"] == 3 and got["static"]["DMUL"] == 1
    assert got["fast"] == {"LDS": 1, "FMUL": 1, "FSETP": 1, "FFMA": 3, "BRA": 3}
    assert cp.parse_sass(STEP_SASS)["_ZN12_GLOBAL__N_114rollout_kernelILi1EEEv9RowConstsPKfS3_Pfii"][
        "loop"]["BAR"] == 1          # parse_sass's outermost loop is the chunk loop
    with pytest.raises(ValueError, match="0 functions"):
        cp.step_loop(STEP_SASS, "window_eval_kernel")


PAIR_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_125window_pair_wrench_kernelILi0ELb0EEEv9RowConstsPKfS3_Pfii9SqScratch
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                @P0 BRA 0xa0 ;
        /*0030*/                   FFMA R6, R0, R7, R8 ;
        /*0040*/                   FFMA R6, R6, R7, R8 ;
        /*0050*/                   MUFU.RCP R2, R3 ;
        /*0060*/                   STS.128 [R4], R8 ;
        /*0070*/                   BAR.SYNC R5, 0x40 ;
        /*0080*/                   LDS R9, [R4] ;
        /*0090*/                @P1 BRA 0x30 ;
        /*00a0*/                   FFMA R6, R0, R7, R8 ;
        /*00b0*/                   STS [R4], R8 ;
        /*00c0*/                   BAR.SYNC R5, 0x40 ;
        /*00d0*/                   LDS.128 R8, [R4] ;
        /*00e0*/                   FMUL R6, R6, R7 ;
        /*00f0*/                @P2 BRA 0xa0 ;
        /*0100*/                @P3 BRA 0x10 ;
        /*0110*/                   EXIT ;
"""


def test_step_loops_finds_each_warps_loop_of_a_warp_pair_kernel():
    """Both warps' loops hold FFMA; the chunk loop around them holds both
    and is not a step loop; the kinematic warp's holds the MUFU."""
    got = cp.step_loops(PAIR_SASS, "25window_pair_wrench_kernelILi0ELb0E")
    assert [g["window"] for g in got] == [(0x30, 0x90), (0xa0, 0xf0)]
    assert got[0]["fast"] == {"FFMA": 2, "MUFU.RCP": 1, "STS": 1, "BAR": 1, "LDS": 1, "BRA": 1}
    assert got[1]["fast"] == {"FFMA": 1, "STS": 1, "BAR": 1, "LDS": 1, "FMUL": 1, "BRA": 1}
    # the one-loop reading would take the chunk loop: neither warp's loop
    # holds 90% of its FFMA
    assert cp.step_loop(PAIR_SASS, "25window_pair_wrench_kernelILi0ELb0E")["window"] == (0x10, 0x100)


def test_ptxas_resources_reads_each_function():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a14rollout_kernelILi1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN1a14rollout_kernelILi1EEEv
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN1a7probe' for 'sm_90a'
ptxas info    : Function properties for _ZN1a7probe
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers
"""
    got = _build.ptxas_resources(log)
    assert got["_ZN1a14rollout_kernelILi1EEEv"] == dict(regs=72, stack=32, spill_stores=0,
                                                       spill_loads=0)
    assert got["_ZN1a7probe"] == dict(regs=255, stack=0, spill_stores=8, spill_loads=4)


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


KERNELS = {  # case: (launch count, launch, plain, extra arguments)
    "fma_peak": ("fma_peak", cp.launch_fma_peak, cp.fma_peak_plain, ()),
    "transcendental_peak": ("transcendental_peak", cp.launch_transcendental_peak,
                            cp.transcendental_peak_plain, ()),
    "fma_tree_peak": ("fma_tree_peak", cp.launch_fma_tree_peak, cp.fma_tree_peak_plain, ()),
    "quat_mix_peak-rk4": ("quat_mix_peak", cp.launch_quat_mix_peak, cp.quat_mix_peak_plain,
                          ("rk4",)),
    "quat_mix_peak-euler": ("quat_mix_peak", cp.launch_quat_mix_peak, cp.quat_mix_peak_plain,
                            ("euler",)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KERNELS))
def test_probe_kernel_matches_plain_on_card(case, cuda, rng):
    name, launch, plain, extra = KERNELS[case]
    x = torch.from_numpy(rng.uniform(0.3, 0.7, size=1000).astype(np.float32)).to(cuda)
    before = _build.launches[name]
    got = launch(x, 16, *extra)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    want = plain(x, 16, *extra)
    if name == "fma_peak":
        got, want = cp.fma_peak_increment(x, got), cp.fma_peak_increment(x, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_measured_rates_are_finite_and_positive(cuda):
    rates = [cp.measure_fma_peak(lanes=8192, iters=256, device=cuda),
             cp.measure_transcendental_peak(lanes=8192, iters=64, device=cuda),
             cp.measure_fma_tree_peak(lanes=8192, iters=16, device=cuda),
             cp.measure_quat_mix_peak("euler", lanes=8192, iters=16, device=cuda)]
    assert all(np.isfinite(r) and r > 0 for r in rates)

#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check its kernels.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); without a card it exits non-zero
and prints no result.  It imports nothing of JAX or of the JAX package.

Phases (any failure raises and ends the run with a non-zero code):

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every kernel from ``bluerov2_dynamics_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. main paths, each with every launch count set to 0 just before it and
   read just after; each must have launched its kernels:
   - K1: the shared-input RK4 rollout at B=65,536 x T=500 through
     ``make_rollout_final_cuda``;
   - T2: the tank app's Fossen evaluator (Euler) at H = 1, 10, 100 on a
     9,165-row recording through ``apps.tank_koopman.fossen_evaluator`` (K2);
   - T3: the wrench app's evaluator on the same recording's wrench through
     ``apps.tank_wrench_comp.fossen_wrench_evaluator`` (K4);
   - T4: the quaternion app's evaluator on its quat13 version through
     ``apps.tank_wrench_quat.fossen_quat_evaluator`` (K5);
   - K6: the quat13 shared-wrench RK4 rollout at 65,536 x 500 through
     ``make_rollout_final_cuda_quat``;
   - K3: the per-trajectory-command RK4 rollout at 65,536 x 500 through
     ``make_batched_rollout_cuda``;
4. checks: each kernel against its plain PyTorch version on the same card
   inputs, the evaluators' RMSEs against the plain step loops, K6's
   quaternion norms, and small inputs against the plain versions on the
   host CPU;
5. timing with CUDA events: each kernel and its plain version, the window
   kernels at 9,065 and 44,800 starts, and the calls end to end;
6. K7: the three sharded window evaluators (``parallel.sharded``) at
   44,800 starts x H=100 (Euler) on a one-rank NCCL group, held against
   the unsharded kernels and the plain versions; then four contiguous
   blocks through the same per-rank body, whose squared errors must sum to
   the world-1 result (world > 1 needs one card per rank: NCCL refuses two
   ranks on one card, so the 4-rank runs are the CPU tests' work);
7. K8: the four ceiling probes at 65,536 lanes, each at the block size
   that measures fastest, with the card's clocks and power beside each
   rate; each kernel against its plain version at 16 iterations; the
   probes' loop bodies as ``cuobjdump -sass`` shows them (the fma probe
   is held by its increment, the mix probe at both quat13 budgets);
8. the measured ceilings of K1-K7 from the probes' rates, and the
   measured price of one sinf and one rsqrtf in FMA-tree flops;
9. one JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DT = 0.02
B_ROLL, T_ROLL = 65_536, 500        # bench.py run_pallas / sec_quat_rollout shape
N_REC = 9_165                       # the tank recording's test split
H_APP = (1, 10, 100)
N_LARGE = 44_800                    # full-recording start count

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
# The bounds price the audited step counts (eval/op_counts.py) at these
# peaks, with a division or rsqrt at 8 and a sinf/cosf at 16 operations;
# the ceilings price them at the rates the K8 probes measure.
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
K7_BACKEND = "nccl"
K7_BLOCKS = 4                       # offset blocks of the world-1 check
PROBE_BLOCKS = (128, 256, 512)      # threads per block tried for each probe
CHECK_ITERS = 16                    # probe iterations of the check against the plain versions

# |kernel - plain| <= atol + rtol * |plain|, elementwise, as (rtol, atol).
# The kernels and their plain versions do the same float32 operations in
# the same order, except that nvcc contracts a*b+c into a fused
# multiply-add (and the plain tau_seq sums its small matrix products in the
# library's order, and CUDA's rsqrtf is not correctly rounded).  The
# rollout and window bounds are the JAX package's own for its kernels
# (tests/test_pallas_rollout.py, test_pallas_eval.py, test_pallas_quat.py);
# the windows add rtol 2e-4, since the recording's positions reach metres;
# tau_seq reaches ~50 N, where one float32 ulp is 3.8e-6.
TOL = {
    "rollout_final": (0.0, 2e-5),        # RK4, 500 steps
    "shared_tau": (1e-5, 1e-4),
    "window_eval": (2e-4, 2e-5),         # Euler, H=100
    "batched_rollout": (2e-4, 2e-5),     # RK4, 500 steps, per-trajectory commands
    "window_eval_wrench": (2e-4, 2e-5),  # Euler, H=100
    "window_eval_quat": (2e-4, 2e-5),    # Euler, H=100
    "rollout_final_quat": (0.0, 2e-5),   # RK4, 500 steps
    "rmse": (1e-4, 0.0),
    "quat_norm": (0.0, 1e-5),
    # K7 against the unsharded kernel: the same per-rank kernel, one float32
    # sum reordered (against the plain versions K7 keeps "rmse")
    "sharded_rmse": (1e-5, 0.0),
    # K8 at CHECK_ITERS: one rounding of a fused multiply-add where the
    # plain version has two, over 16 dependent steps.  The fma probe is held
    # by its increment (cuda_probes.fma_peak_increment): its output moves
    # only ~1e-7 per iteration, its increment by 1/CHECK_ITERS of itself
    "fma_peak": (1e-5, 0.0),
    "transcendental_peak": (1e-5, 0.0),
    "fma_tree_peak": (1e-5, 0.0),
    "quat_mix_peak": (1e-5, 0.0),
}
# K3's white-noise commands tip a few trajectories over: where pitch passes
# +-pi/2 the euler12 rates divide by the clamped cos(theta) and the path is
# chaotic (float32 and float64 runs of the same plain code part by ~1e2).
# A float64 step loop over the same commands marks every trajectory whose
# pitch comes within 0.07 rad of the singularity; those are counted and
# left out of K3's elementwise check, which fails if they are over 1%.
GIMBAL_MARGIN = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(got, want, name):
    rtol, atol = TOL[name]
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    d = (got - want).abs()
    bad = d > atol + rtol * want.abs()
    err = float(d.max())
    print(f"{name}: max|kernel - plain| = {err:.3e} (rtol {rtol:g}, atol {atol:g})")
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements outside the tolerance")
    return err


def close(got: float, want: float, rtol: float, what: str) -> None:
    print(f"{what}: {got:.9g} vs {want:.9g} (rel {abs(got - want) / abs(want):.3e}, "
          f"rtol {rtol:g})")
    if not abs(got - want) <= rtol * abs(want):
        fail(f"{what}: {got} vs {want}, outside rtol {rtol}")


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ar1_commands(rng, n, alpha=0.98, noise=0.02):
    """Smooth random commands u_{k+1} = clip(alpha u_k + noise N(0, 1))."""
    U = np.empty((n, 8), np.float32)
    u = np.zeros(8)
    for k in range(n):
        u = np.clip(alpha * u + noise * rng.normal(size=8), -1.0, 1.0)
        U[k] = u
    return U


def gimbal_near(fossen, p, cfg, lag, x0, U):
    """Trajectories of ``x0 (B, 12)`` under ``U (T, B, 8)`` whose pitch
    reaches ``GIMBAL_MARGIN`` in a float64 step loop (RK4) with the same
    stored coefficients."""
    p64, cfg64, lag64 = (type(c)(*(f.double() for f in c)) for c in (p, cfg, lag))
    step = fossen.make_thruster_step(p64, cfg64, lag64, DT, "rk4")
    x = x0.double()
    L = torch.zeros((x0.shape[0], 8, 3), dtype=torch.float64, device=x0.device)
    peak = torch.zeros(x0.shape[0], dtype=torch.float64, device=x0.device)
    for t in range(U.shape[0]):
        x, L = step((x, L), U[t].double())
        peak = torch.maximum(peak, x[:, 4].abs())
    return peak >= GIMBAL_MARGIN


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")

    from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp import (
        fossen_wrench_evaluator, wrench_dataset)
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import (
        fossen_quat_evaluator, quat_dataset)
    import torch.distributed as dist

    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.eval.op_counts import (
        DIV_OPS, QUAT_BUDGET, ROW_BUDGET, TRIG_OPS, actuation_ops, quat_ops, row_ops)
    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time, time_fn
    from bluerov2_dynamics_tpu_torch.models import fossen
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr
    from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    spills = [line.strip() for line in logs["probes"].splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        fail(f"a probe spills, so it measures local memory and not the card's FP32 rate: {spills}")

    # 3. inputs and the main paths ----------------------------------------------
    rng = np.random.default_rng(SEED)
    x0 = torch.from_numpy((0.1 * rng.normal(size=(B_ROLL, 12))).astype(np.float32)).to(dev)
    U = torch.from_numpy(np.clip(0.5 * rng.normal(size=(T_ROLL, 8)), -1, 1)
                         .astype(np.float32)).to(dev)
    p, cfg, lag = fossen_params(device=dev), thruster_config(device=dev), lag_params(DT, device=dev)

    # the recording: the port's own simulator on the card, plus sensor noise
    t0 = time.perf_counter()
    U_rec = torch.from_numpy(ar1_commands(rng, N_REC)).to(dev)
    x_start = torch.zeros(12, device=dev)
    x_start[2] = 1.0
    X_true = fossen.simulate_thruster(p, cfg, lag, x_start, U_rec, DT, "euler")[:-1]
    noise = torch.from_numpy((1e-3 * rng.normal(size=(N_REC, 12))).astype(np.float32)).to(dev)
    X_rec = (X_true + noise).contiguous()
    if not torch.isfinite(X_rec).all():
        fail("the simulated recording is not finite")
    print(f"recording: {N_REC} rows simulated on the card in {time.perf_counter() - t0:.1f} s")
    # T3/T4 inputs: the recorded vehicle's wrench; quaternions in float64 on the host
    X_np, U_np = X_rec.cpu().numpy(), U_rec.cpu().numpy()
    _, W_np = wrench_dataset(X_np, U_np)
    X13_np, _ = quat_dataset(X_np, U_np)
    W_rec = torch.as_tensor(W_np, dtype=torch.float32, device=dev).contiguous()
    X13_rec = torch.as_tensor(X13_np, dtype=torch.float32, device=dev).contiguous()
    # K6 inputs (bench.py:735-741) and K3's per-trajectory commands (1.05 GB)
    xq0_np = 0.1 * rng.normal(size=(B_ROLL, 13))
    xq0_np[:, 3] += 1.0
    xq0 = torch.from_numpy(xq0_np.astype(np.float32)).to(dev)
    TAUq = torch.from_numpy((3.0 * rng.normal(size=(T_ROLL, 6))).astype(np.float32)).to(dev)
    Ub = torch.from_numpy(np.clip(0.5 * rng.standard_normal((T_ROLL, B_ROLL, 8), dtype=np.float32),
                                  -1, 1)).to(dev)

    launches = {}

    def drive(phase, names, fn, into=launches):
        """Run ``fn`` with the launch counts set to 0 just before and read
        just after into ``into``; every kernel of ``names`` must have
        launched."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {n: _build.launches[n] for n in names}
        print(f"{phase}: launches {counts}")
        for n, c in counts.items():
            if c < 1:
                fail(f"kernel {n} was not launched on the {phase} path")
        into.update(counts)
        return out

    roll = cr.make_rollout_final_cuda(p, cfg, lag, DT, "rk4")
    xT = drive("K1 rollout", ("shared_tau", "rollout_final"), lambda: roll(x0, U))
    evaluate = fossen_evaluator(DT, X_rec, U_rec, method="euler")
    rmses = drive("T2 evaluator", ("window_eval",),
                  lambda: {H: float(evaluate(H)) for H in H_APP})
    evaluate3 = fossen_wrench_evaluator(DT, X_rec, W_rec, method="euler")
    rmses3 = drive("T3 evaluator", ("window_eval_wrench",),
                   lambda: {H: float(evaluate3(H)) for H in H_APP})
    evaluate4 = fossen_quat_evaluator(DT, X13_rec, W_rec, method="euler")
    rmses4 = drive("T4 evaluator", ("window_eval_quat",),
                   lambda: {H: float(evaluate4(H)) for H in H_APP})
    roll_q = cq.make_rollout_final_cuda_quat(p, DT, "rk4")
    xqT = drive("K6 quat13 rollout", ("rollout_final_quat",), lambda: roll_q(xq0, TAUq))
    roll_b = ce.make_batched_rollout_cuda(p, cfg, lag, DT, "rk4")
    xbT = drive("K3 batched rollout", ("batched_rollout",), lambda: roll_b(x0, Ub))

    for app, r in (("T2", rmses), ("T3", rmses3), ("T4", rmses4)):
        print(f"{app} endpoint RMSE (Euler): " + ", ".join(f"H={H}: {v:.6f}" for H, v in r.items()))
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"a {app} endpoint RMSE is not finite")
    for name, out, shape in (("rollout", xT, (B_ROLL, 12)), ("quat13 rollout", xqT, (B_ROLL, 13)),
                             ("batched rollout", xbT, (B_ROLL, 12))):
        if out.shape != shape or not torch.isfinite(out).all():
            fail(f"{name} output is not finite {shape}")

    # 4. checks -------------------------------------------------------------------
    tc, rc = cr.thruster_consts(cfg, lag), cr.row_consts(p, DT)
    tau_k = cr.launch_tau_seq(tc, U)
    tau_p = cr.shared_tau_sequence(cfg, lag, U)
    err = {"shared_tau": max_err(tau_k, tau_p, "shared_tau"),
           "rollout_final": max_err(xT, cr.rollout_rows_plain(p, tau_p, x0, DT, "rk4"),
                                    "rollout_final")}
    H = H_APP[-1]
    err["window_eval"] = max_err(ce.launch_window_eval(rc, tc, X_rec, U_rec, H, "euler", True),
                                 ce.endpoint_final_plain(p, cfg, lag, X_rec, U_rec, DT, H, "euler"),
                                 "window_eval")
    err["window_eval_wrench"] = max_err(
        ce.launch_window_eval_wrench(rc, X_rec, W_rec, H, "euler"),
        ce.endpoint_final_wrench_plain(p, X_rec, W_rec, DT, H, "euler"), "window_eval_wrench")
    err["window_eval_quat"] = max_err(
        cq.launch_window_eval_quat(rc, X13_rec, W_rec, H, "euler", True),
        cq.endpoint_final_quat_plain(p, X13_rec, W_rec, DT, H, "euler"), "window_eval_quat")
    err["rollout_final_quat"] = max_err(xqT, cq.rollout_final_quat_plain(p, xq0, TAUq, DT, "rk4"),
                                        "rollout_final_quat")
    near = gimbal_near(fossen, p, cfg, lag, x0, Ub)
    xb_plain = ce.batched_rollout_plain(p, cfg, lag, x0, Ub, DT, "rk4")
    n_near = int(near.sum())
    near_diff = float((xbT[near] - xb_plain[near]).abs().max()) if n_near else 0.0
    print(f"K3: {n_near} of {B_ROLL} trajectories come within {np.pi / 2 - GIMBAL_MARGIN:.3f} rad "
          f"of the gimbal singularity (max|kernel - plain| there {near_diff:.3e}); "
          f"the check holds the other {B_ROLL - n_near}")
    if n_near > B_ROLL // 100:
        fail(f"K3: {n_near} trajectories near the gimbal singularity, over 1%")
    err["batched_rollout"] = max_err(xbT[~near], xb_plain[~near], "batched_rollout")
    norm_dev = float((torch.linalg.norm(xqT[:, 3:7].double(), dim=1) - 1.0).abs().max())
    print(f"K6 quaternion norms: max |norm - 1| = {norm_dev:.3e}")
    if norm_dev > TOL["quat_norm"][1]:
        fail(f"K6 quaternion norms drift by {norm_dev}")

    step = fossen.make_thruster_step(p, cfg, lag, DT, "euler")
    step3 = fossen.make_wrench_step(p, DT, "euler", state="euler12")
    step4 = fossen.make_wrench_step(p, DT, "euler", state="quat13")
    for H in H_APP:
        loops = {
            "T2": (rmses, metrics.endpoint_rmse_carry(
                step, lambda x: torch.zeros((*x.shape[:-1], 8, 3), device=dev), X_rec, U_rec, H)),
            "T3": (rmses3, metrics.endpoint_rmse(step3, X_rec, W_rec, H)),
            "T4": (rmses4, metrics.endpoint_rmse(step4, X13_rec, W_rec, H)),
        }
        for app, (got, want) in loops.items():
            want = float(want)
            if abs(got[H] - want) > TOL["rmse"][0] * abs(want):
                fail(f"{app} RMSE at H={H}: kernel path {got[H]} vs step loop {want}")
    print("T2/T3/T4 RMSEs agree with the plain step loops to rtol 1e-4")

    # small inputs against the plain versions on the host CPU
    cpu = torch.device("cpu")
    pc, cfgc, lagc = p.to(cpu), cfg.to(cpu), lag.to(cpu)
    max_err(roll(x0[:256].contiguous(), U[:50].contiguous()),
            cr.rollout_final_plain(pc, cfgc, lagc, x0[:256].cpu(), U[:50].cpu(), DT, "rk4"),
            "rollout_final")
    Xs, Uss, Ws, X13s = X_rec[:300], U_rec[:300], W_rec[:300], X13_rec[:300]
    max_err(ce.make_endpoint_final_cuda(p, cfg, lag, DT, 20, "euler")(Xs, Uss),
            ce.endpoint_final_plain(pc, cfgc, lagc, Xs.cpu(), Uss.cpu(), DT, 20, "euler"),
            "window_eval")
    max_err(ce.make_endpoint_final_cuda_wrench(p, DT, 20, "euler")(Xs, Ws),
            ce.endpoint_final_wrench_plain(pc, Xs.cpu(), Ws.cpu(), DT, 20, "euler"),
            "window_eval_wrench")
    max_err(cq.make_endpoint_final_cuda_quat(p, DT, 20, "euler")(X13s, Ws),
            cq.endpoint_final_quat_plain(pc, X13s.cpu(), Ws.cpu(), DT, 20, "euler"),
            "window_eval_quat")
    max_err(roll_q(xq0[:256].contiguous(), TAUq[:50].contiguous()),
            cq.rollout_final_quat_plain(pc, xq0[:256].cpu(), TAUq[:50].cpu(), DT, "rk4"),
            "rollout_final_quat")
    Ubs = Ub[:50, :256].contiguous()
    max_err(roll_b(x0[:256].contiguous(), Ubs),
            ce.batched_rollout_plain(pc, cfgc, lagc, x0[:256].cpu(), Ubs.cpu(), DT, "rk4"),
            "batched_rollout")
    print("small inputs agree with the plain versions on the host CPU")

    # 5. timing -------------------------------------------------------------------
    ms, plain_ms, bounds, shapes = {}, {}, {}, {}
    ms["rollout_final"] = cuda_event_time(lambda: cr.launch_rollout(rc, tau_k, x0, "rk4"), iters=10)
    plain_ms["rollout_final"] = cuda_event_time(
        lambda: cr.rollout_rows_plain(p, tau_p, x0, DT, "rk4"), iters=2, warmup=0)
    ms["shared_tau"] = cuda_event_time(lambda: cr.launch_tau_seq(tc, U), iters=50)
    plain_ms["shared_tau"] = cuda_event_time(lambda: cr.shared_tau_sequence(cfg, lag, U), iters=3)
    ms["rollout_final_quat"] = cuda_event_time(
        lambda: cq.launch_rollout_quat(rc, xq0, TAUq, "rk4", True), iters=10)
    plain_ms["rollout_final_quat"] = cuda_event_time(
        lambda: cq.rollout_final_quat_plain(p, xq0, TAUq, DT, "rk4"), iters=2, warmup=0)
    ms["batched_rollout"] = cuda_event_time(
        lambda: ce.launch_batched_rollout(rc, tc, x0, Ub, "rk4", True), iters=10)
    plain_ms["batched_rollout"] = cuda_event_time(
        lambda: ce.batched_rollout_plain(p, cfg, lag, x0, Ub, DT, "rk4"), iters=2, warmup=0)
    host = {}
    for name, fn, args in (("rollout_final", roll, (x0, U)), ("rollout_final_quat", roll_q, (xq0, TAUq)),
                           ("batched_rollout", roll_b, (x0, Ub))):
        _, host[name] = time_fn(fn, *args, warmup=1, iters=5)
    for name, label in (("rollout_final", "K1 make_rollout_final_cuda"),
                        ("rollout_final_quat", "K6 make_rollout_final_cuda_quat"),
                        ("batched_rollout", "K3 make_batched_rollout_cuda")):
        print(f"{label}: kernel {ms[name]:.4f} ms (plain {plain_ms[name]:.1f} ms); end to end "
              f"{1e3 * host[name]:.4f} ms = {B_ROLL * T_ROLL / host[name]:.4e} RK4 "
              f"trajectory-steps/s")
    print(f"K1 tau_seq kernel {ms['shared_tau']:.4f} ms (plain {plain_ms['shared_tau']:.2f} ms)")

    nnz = int((cfg.wrench_map != 0).sum())
    act_ops = actuation_ops(nnz)
    steps = B_ROLL * T_ROLL
    bounds["rollout_final"] = bound(steps * row_ops("rk4"), 4 * (2 * B_ROLL * 12 + T_ROLL * 6))
    bounds["shared_tau"] = bound(T_ROLL * act_ops, 4 * T_ROLL * (8 + 6))
    bounds["rollout_final_quat"] = bound(steps * quat_ops("rk4"), 4 * (2 * B_ROLL * 13 + T_ROLL * 6))
    bounds["batched_rollout"] = bound(steps * (row_ops("rk4") + act_ops),
                                      4 * (2 * B_ROLL * 12 + T_ROLL * B_ROLL * 8))
    shapes["rollout_final"] = f"x0 ({B_ROLL}, 12), tau_seq ({T_ROLL}, 6), RK4"
    shapes["shared_tau"] = f"U ({T_ROLL}, 8) -> tau_seq ({T_ROLL}, 6)"
    shapes["rollout_final_quat"] = f"x0 ({B_ROLL}, 13), TAU ({T_ROLL}, 6), RK4, renormalised"
    shapes["batched_rollout"] = f"x0 ({B_ROLL}, 12), U ({T_ROLL}, {B_ROLL}, 8), RK4, lag"

    # the window kernels at the apps' starts and at the full recording's
    H = H_APP[-1]
    N = N_LARGE + H
    X12_l = torch.from_numpy((0.1 * rng.normal(size=(N, 12))).astype(np.float32)).to(dev)
    U8_l = torch.from_numpy(np.clip(0.5 * rng.normal(size=(N, 8)), -1, 1).astype(np.float32)).to(dev)
    TAU_l = torch.from_numpy((4.0 * rng.normal(size=(N, 6))).astype(np.float32)).to(dev)
    X13_np_l = 0.1 * rng.normal(size=(N, 13))
    X13_np_l[:, 3] += 1.0
    X13_l = torch.from_numpy(X13_np_l.astype(np.float32)).to(dev)
    windows = {
        "window_eval": (
            lambda X, Ui: ce.launch_window_eval(rc, tc, X, Ui, H, "euler", True),
            lambda X, Ui: ce.endpoint_final_plain(p, cfg, lag, X, Ui, DT, H, "euler"),
            row_ops("euler") + act_ops, 8, ((X_rec, U_rec), (X12_l, U8_l))),
        "window_eval_wrench": (
            lambda X, Ti: ce.launch_window_eval_wrench(rc, X, Ti, H, "euler"),
            lambda X, Ti: ce.endpoint_final_wrench_plain(p, X, Ti, DT, H, "euler"),
            row_ops("euler"), 6, ((X_rec, W_rec), (X12_l, TAU_l))),
        "window_eval_quat": (
            lambda X, Ti: cq.launch_window_eval_quat(rc, X, Ti, H, "euler", True),
            lambda X, Ti: cq.endpoint_final_quat_plain(p, X, Ti, DT, H, "euler"),
            quat_ops("euler"), 6, ((X13_rec, W_rec), (X13_l, TAU_l))),
    }
    large = {}
    for name, (kern, plain, ops_step, n_in, inputs) in windows.items():
        for X, Ui in inputs:
            n_start, n_state = X.shape[0] - H, X.shape[1]
            k_ms = cuda_event_time(lambda: kern(X, Ui), iters=20)
            p_ms = cuda_event_time(lambda: plain(X, Ui), iters=3)
            b = bound(n_start * H * ops_step, 4 * (n_start * n_state * 2 + X.shape[0] * n_in))
            shape = (f"X ({X.shape[0]}, {n_state}), input ({X.shape[0]}, {n_in}), "
                     f"{n_start} starts x H={H}, Euler")
            print(f"{name} at {n_start} starts: {k_ms:.4f} ms (plain {p_ms:.1f} ms, "
                  f"bound {b[0]:.4f} ms by {b[1]})")
            if n_start == N_REC - H:
                ms[name], plain_ms[name], bounds[name], shapes[name] = k_ms, p_ms, b, shape
            else:
                large[name] = dict(shape=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                                   bound_by=b[1])
    for label, fn in (("fossen_evaluator", evaluate), ("fossen_wrench_evaluator", evaluate3),
                      ("fossen_quat_evaluator", evaluate4)):
        _, t_eval = time_fn(fn, H, warmup=1, iters=5)
        print(f"{label}(H={H}) end to end: {1e3 * t_eval:.4f} ms ({N_REC - H} starts)")

    # 6. K7: the sharded window evaluators, world 1 -------------------------------
    m_blk = N_LARGE // K7_BLOCKS
    k7 = {  # name: (per-rank kernel, sharded wrapper, single-device evaluator, X, input)
        "sharded_window_eval": (
            "window_eval",
            lambda mesh, X, Ui: sharded.shardmap_endpoint_rmse_cuda(
                mesh, p, cfg, lag, X, Ui, DT, H, method="euler"),
            ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "euler"), X12_l, U8_l),
        "sharded_window_eval_wrench": (
            "window_eval_wrench",
            lambda mesh, X, Ti: sharded.shardmap_endpoint_rmse_cuda_wrench(
                mesh, p, X, Ti, DT, H, method="euler"),
            ce.make_endpoint_final_cuda_wrench(p, DT, H, "euler"), X12_l, TAU_l),
        "sharded_window_eval_quat": (
            "window_eval_quat",
            lambda mesh, X, Ti: sharded.shardmap_endpoint_rmse_cuda_quat(
                mesh, p, X, Ti, DT, H, method="euler"),
            cq.make_endpoint_final_cuda_quat(p, DT, H, "euler"), X13_l, TAU_l),
    }
    k7_launches, wrapper_ms, k7_unsharded_err = {}, {}, {}
    pmesh.init_group(K7_BACKEND, device=dev)
    try:
        mesh1 = pmesh.make_mesh(axis_names=("data",), device_type="cuda")
        print(f"K7: {K7_BACKEND} group of {dist.get_world_size()} rank, mesh {mesh1}")

        def k7_path():
            out = {}
            for name, (_, wrapper, final_fn, X, Ui) in k7.items():
                world1 = wrapper(mesh1, X, Ui)
                sq = sum(sharded.window_block_sq(final_fn, X, Ui, H, r * m_blk, m_blk)
                         for r in range(K7_BLOCKS))
                out[name] = (float(world1), float(torch.sqrt(sq / (N_LARGE * X.shape[1]))))
            return out

        k7_res = drive("K7 sharded windows (world 1, then 4 offset blocks)",
                       [v[0] for v in k7.values()], k7_path, into=k7_launches)
        for kname, c in k7_launches.items():
            if c != 1 + K7_BLOCKS:
                fail(f"K7: kernel {kname} launched {c} times, not 1 + {K7_BLOCKS}")
        for name, (kname, wrapper, final_fn, X, Ui) in k7.items():
            world1, blocks = k7_res[name]
            plain = windows[kname][1]
            unsharded = float(metrics.rmse(X[H:], final_fn(X, Ui)))
            close(world1, unsharded, TOL["sharded_rmse"][0],
                  f"{name}: world-1 RMSE vs the unsharded kernel's")
            k7_unsharded_err[name] = abs(world1 - unsharded)
            close(blocks, world1, TOL["sharded_rmse"][0],
                  f"{name}: {K7_BLOCKS} offset blocks vs world 1")
            want = float(metrics.rmse(X[H:], plain(X, Ui)))
            close(world1, want, TOL["rmse"][0], f"{name}: world-1 RMSE vs the plain versions'")
            err[name] = abs(world1 - want)
            ms[name] = cuda_event_time(
                lambda: sharded.shardmap_window_rmse(mesh1, final_fn, X, Ui, H), iters=20)
            wrapper_ms[name] = cuda_event_time(lambda: wrapper(mesh1, X, Ui), iters=20)
            plain_ms[name] = cuda_event_time(lambda: metrics.rmse(X[H:], plain(X, Ui)), iters=2,
                                             warmup=0)
            bounds[name] = (large[kname]["bound_ms"], large[kname]["bound_by"])
            shapes[name] = large[kname]["shape"] + f", world 1 ({K7_BACKEND})"
            print(f"{name}: {ms[name]:.4f} ms with the all-reduce; the bare kernel "
                  f"{large[kname]['ms']:.4f} ms; the wrapper, which reads the coefficients "
                  f"back to the host on every call, {wrapper_ms[name]:.4f} ms")
    finally:
        dist.destroy_process_group()

    # 7. K8: the ceiling probes -------------------------------------------------------
    def clocks():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()

    L = cp.LANES
    probes = {  # name: (measure, launch, plain, budget kwargs, work units per call, unit)
        "fma_peak": (cp.measure_fma_peak, cp.launch_fma_peak, cp.fma_peak_plain, {},
                     3 * L * cp.ITERS["fma_peak"] * cp.STREAMS, "flops/s"),
        "transcendental_peak": (
            cp.measure_transcendental_peak, cp.launch_transcendental_peak,
            cp.transcendental_peak_plain, {}, L * cp.ITERS["transcendental_peak"] * cp.STREAMS,
            "sinf/s"),
        "fma_tree_peak": (cp.measure_fma_tree_peak, cp.launch_fma_tree_peak,
                          cp.fma_tree_peak_plain, {},
                          cp.FMA_TREE_FLOPS_PER_ITER * L * cp.ITERS["fma_tree_peak"], "flops/s"),
        "quat_mix_peak": (cp.measure_quat_mix_peak, cp.launch_quat_mix_peak,
                          cp.quat_mix_peak_plain, {"method": "rk4"},
                          L * cp.ITERS["quat_mix_peak"], "quat13 RK4 steps/s"),
    }
    k8_launches = {}

    def k8_path():
        out = {}
        for name, (measure, _, _, kw, _, unit) in probes.items():
            sweep = {b: measure(block=b, device=dev, **kw) for b in PROBE_BLOCKS}
            best = max(sweep, key=sweep.get)
            out[name] = (sweep[best], best, sweep)
            print(f"K8 {name}: " + ", ".join(f"block {b}: {r:.6e}" for b, r in sweep.items())
                  + f" {unit}; clocks.sm, power.draw, power.limit: {clocks()}")
        out["quat_mix_euler"] = cp.measure_quat_mix_peak(
            "euler", block=out["quat_mix_peak"][1], device=dev)
        print(f"K8 quat_mix_peak at the Euler budget: {out['quat_mix_euler']:.6e} quat13 Euler "
              f"steps/s; clocks.sm, power.draw, power.limit: {clocks()}")
        return out

    rates = drive("K8 probes", list(probes), k8_path, into=k8_launches)
    xs = torch.from_numpy(rng.uniform(0.3, 0.7, size=L).astype(np.float32)).to(dev)
    k8_meta = {}

    def probe_err(name, launch, plain, block, kw):
        got, want = launch(xs, CHECK_ITERS, block=block, **kw), plain(xs, CHECK_ITERS, **kw)
        if name == "fma_peak":
            print("fma_peak: held by its increment over the streams' starting sum")
            got, want = cp.fma_peak_increment(xs, got), cp.fma_peak_increment(xs, want)
        return max_err(got, want, name)

    for name, (_, launch, plain, kw, work, unit) in probes.items():
        rate, block, sweep = rates[name]
        err[name] = probe_err(name, launch, plain, block, kw)
        ms[name] = 1e3 * work / rate
        plain_ms[name] = cuda_event_time(lambda: plain(xs, CHECK_ITERS, **kw), iters=2)
        k8_meta[name] = dict(
            rate=rate, rate_unit=unit, block=block, sweep={str(b): r for b, r in sweep.items()},
            lanes=L, iters=cp.ITERS[name], check_iters=CHECK_ITERS,
            kernel_ms_at_check_iters=cuda_event_time(
                lambda: launch(xs, CHECK_ITERS, block=block, **kw), iters=20))
    ops_per_unit = {"fma_peak": 1, "transcendental_peak": TRIG_OPS + 2, "fma_tree_peak": 1,
                    "quat_mix_peak": quat_ops("rk4")}
    for name, (*_, work, _) in probes.items():
        bounds[name] = bound(work * ops_per_unit[name], 8 * L)
        shapes[name] = (f"{L} lanes x {cp.ITERS[name]} iterations at {k8_meta[name]['block']} "
                        f"threads per block; plain version at {CHECK_ITERS} iterations")
    k8_meta["quat_mix_peak"]["rate_euler"] = rates["quat_mix_euler"]
    # the Euler budget's instantiation, quat_mix_kernel<118, 2, 14>, prices K5 and K7
    print("quat_mix_peak at the Euler budget:")
    mix_err = {"rk4": err["quat_mix_peak"],
               "euler": probe_err("quat_mix_peak", cp.launch_quat_mix_peak,
                                  cp.quat_mix_peak_plain, rates["quat_mix_peak"][1],
                                  {"method": "euler"})}
    err["quat_mix_peak"] = max(mix_err.values())
    k8_meta["quat_mix_peak"].update(max_abs_err_rk4=mix_err["rk4"],
                                    max_abs_err_euler=mix_err["euler"])

    # each probe's loop must hold its work: (function name part, probe, check)
    mix_plans = [cp.quat_mix_plan(QUAT_BUDGET[m]) for m in ("rk4", "euler")]
    sass_checks = [
        ("fma_peak_kernel", "fma_peak",
         lambda loop, total: loop["FFMA"] >= cp.STREAMS and loop["FFMA"] == loop["FMUL"]),
        ("sin_peak_kernel", "transcendental_peak",      # exact sinf: no MUFU.SIN
         lambda loop, total: total["MUFU.SIN"] == 0 and loop["FFMA"] >= cp.STREAMS),
        ("fma_tree_kernel", "fma_tree_peak",
         lambda loop, total: loop["FFMA"] >= cp.CHAINS * cp.DEPTH),
    ] + [(f"quat_mix_kernelILi{pl['horner']}ELi{pl['n_rsqrt']}E", "quat_mix_peak",
          lambda loop, total, pl=pl: (loop["FFMA"] >= pl["horner"]
                                      and loop["MUFU.RSQ"] == pl["n_rsqrt"]))
         for pl in mix_plans]
    sass = cp.sass_loop_counts("probes")
    if sass is None:
        print("SASS: cuobjdump not found; loop bodies not read")
    else:
        for key, probe, ok in sass_checks:
            fns = [fn for fn in sass if key in fn]
            if len(fns) != 1:
                fail(f"SASS: {len(fns)} functions match {key}")
            loop, total = sass[fns[0]]["loop"], sass[fns[0]]["total"]
            counts = {op: n for op, n in sorted(loop.items())
                      if op in ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP")
                      or op.startswith("MUFU")}
            print(f"SASS {key}: loop body {counts} of {sum(loop.values())} instructions; "
                  f"whole function FFMA {total['FFMA']}, "
                  f"MUFU {sum(n for op, n in total.items() if op.startswith('MUFU'))}")
            k8_meta[probe].setdefault("sass_loop", {})[key] = counts
            if not ok(loop, total):
                fail(f"SASS of {fns[0]}: the loop body does not hold the probe's work")

    # 8. ceilings from the measured rates ----------------------------------------------
    tree = rates["fma_tree_peak"][0]
    sin_rate = rates["transcendental_peak"][0]
    mix = {"rk4": rates["quat_mix_peak"][0], "euler": rates["quat_mix_euler"]}
    sin_price = tree / sin_rate - 2
    rsqrt_price = (tree / mix["rk4"] - 2 * QUAT_BUDGET["rk4"]["slots"]) / QUAT_BUDGET["rk4"]["sqrt"]
    print(f"measured prices in FMA-tree flops: one sinf {sin_price:.2f} (the probe's own FFMA "
          f"taken out), one rsqrtf {rsqrt_price:.2f} (a quat13 RK4 step's {QUAT_BUDGET['rk4']['slots']} "
          f"issue slots at 2 flops each taken out, cheap ops priced as one slot)")
    print(f"FMA-tree rate {tree:.6e} flops/s = {tree / FP32_PEAK:.4f} of {FP32_PEAK:.3g}")

    def row_ceiling(n_steps, method, extra_flops=0):
        b = ROW_BUDGET[method]
        return 1e3 * n_steps * ((b["flops"] + extra_flops + DIV_OPS * b["div"]) / tree
                                + b["trig"] / sin_rate)

    n_app, n_big = (N_REC - H) * H, N_LARGE * H
    ceiling = {
        "rollout_final": row_ceiling(steps, "rk4"),
        "shared_tau": 1e3 * T_ROLL * act_ops / tree,
        "batched_rollout": row_ceiling(steps, "rk4", act_ops),
        "window_eval": row_ceiling(n_app, "euler", act_ops),
        "window_eval_wrench": row_ceiling(n_app, "euler"),
        "window_eval_quat": 1e3 * n_app / mix["euler"],
        "rollout_final_quat": 1e3 * steps / mix["rk4"],
    }
    ceiling_large = {"window_eval": row_ceiling(n_big, "euler", act_ops),
                     "window_eval_wrench": row_ceiling(n_big, "euler"),
                     "window_eval_quat": 1e3 * n_big / mix["euler"]}
    for name, (kname, *_) in k7.items():
        ceiling[name] = ceiling_large[kname]
    for name in ceiling:      # the probes price operations; bytes keep their bound
        if bounds[name][1] == "bytes":
            ceiling[name] = max(ceiling[name], bounds[name][0])
    for name, c in ceiling.items():
        print(f"ceiling {name}: {c:.4f} ms; kernel {ms[name]:.4f} ms = {c / ms[name]:.3f} of it"
              + ("  (FASTER than the additive ceiling)" if ms[name] < c else ""))
    for name, c in ceiling_large.items():
        large[name]["ceiling_ms"] = c
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device query")

    # 9. results ------------------------------------------------------------------
    src = "bluerov2_dynamics_tpu_torch/csrc/"
    k7_src = "bluerov2_dynamics_tpu/parallel/sharded.py:117 _shardmap_window_rmse"
    kernels_meta = [
        ("rollout_final", "rollout.cu",
         "bluerov2_dynamics_tpu/ops/pallas_rollout.py:208 make_rollout_final_pallas"),
        ("shared_tau", "rollout.cu",
         "bluerov2_dynamics_tpu/ops/pallas_rollout.py:34 shared_tau_sequence "
         "(the lax.scan feeding K1, :256)"),
        ("window_eval", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:36 _make_thruster_window_kernel"),
        ("batched_rollout", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:285 make_batched_rollout_pallas"),
        ("window_eval_wrench", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:250 _make_wrench_window_kernel"),
        ("window_eval_quat", "quat.cu",
         "bluerov2_dynamics_tpu/ops/pallas_quat.py:143 _make_quat_window_kernel"),
        ("rollout_final_quat", "quat.cu",
         "bluerov2_dynamics_tpu/ops/pallas_quat.py:170 make_rollout_final_pallas_quat"),
        ("sharded_window_eval", "window_eval.cu", k7_src),
        ("sharded_window_eval_wrench", "window_eval.cu", k7_src),
        ("sharded_window_eval_quat", "quat.cu", k7_src),
        ("fma_peak", "probes.cu", "bench.py:115 measure_vpu_fma_peak (pallas_call :150)"),
        ("transcendental_peak", "probes.cu",
         "bench.py:165 measure_vpu_transcendental_peak (pallas_call :196)"),
        ("fma_tree_peak", "probes.cu", "bench.py:209 measure_vpu_fma_tree_peak (pallas_call :250)"),
        ("quat_mix_peak", "probes.cu", "bench.py:263 measure_quat_mix_peak (pallas_call :354)"),
    ]
    counts = {**launches, **k8_launches,
              **{name: k7_launches[v[0]] for name, v in k7.items()}}
    kernels = []
    for name, source, replaces in kernels_meta:
        rtol, atol = TOL["rmse"] if name in k7 else TOL[name]
        entry = dict(name=name, route="cuda", source=src + source, replaces=replaces,
                     launches=counts[name], max_abs_err=err[name], max_abs_diff=err[name],
                     tol=dict(rtol=rtol, atol=atol), ms=ms[name], kernel_ms=ms[name],
                     plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                     bound_by=bounds[name][1], library_ms=None, shape=shapes[name],
                     ceiling_ms=ceiling.get(name))
        if name in large:
            entry["large"] = large[name]
        if name in k8_meta:
            entry.update(k8_meta[name])
        if name in wrapper_ms:
            rtol, atol = TOL["sharded_rmse"]
            entry.update(wrapper_ms=wrapper_ms[name],
                         max_abs_err_vs_unsharded_kernel=k7_unsharded_err[name],
                         tol_vs_unsharded_kernel=dict(rtol=rtol, atol=atol))
        if name == "batched_rollout":
            entry["checked"] = (f"{B_ROLL - n_near} of {B_ROLL} trajectories; {n_near} near the "
                                f"gimbal singularity left out (max|kernel - plain| {near_diff:.3e})")
        kernels.append(entry)
    print(f"measured prices: " + json.dumps({"sinf_flops": sin_price, "rsqrtf_flops": rsqrt_price,
                                              "fma_tree_share_of_peak": tree / FP32_PEAK}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

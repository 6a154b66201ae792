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
6. one JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
# Operation counts per trajectory and step, from the JAX kernels' jaxprs:
# the euler12 row step as (flops, divisions, sin/cos) (bench.py
# _vector_op_buckets on _pallas_kernel_step), the quat13 step with its
# per-stage and post-step normalise as (flops, rsqrt) (bench.py
# quat_step_op_counts).  An IEEE division and an rsqrt are priced at 8
# FP32 operations (reciprocal estimate and Newton refinement) and an exact
# sinf/cosf at 16 (range reduction, minimax polynomial, quadrant
# selection); these are estimates, not counted instructions.  The audited
# cheap ops (abs, compare, select: 15/60 per euler12 Euler/RK4 step, 14/47
# per quat13 step) are left out of both.
ROW_STEP = {"rk4": (684, 8, 24), "euler": (156, 2, 6)}
QUAT_STEP = {"rk4": (877, 5), "euler": (212, 2)}
DIV_OPS, TRIG_OPS = 8, 16
CURVE_OPS = 10      # per thruster: V*V, four multiply-adds, final multiply
LAG_OPS = 26        # per thruster: three rows of 4 mul + 3 add, then c.N

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


def row_ops(method: str) -> int:
    flops, div, trig = ROW_STEP[method]
    return flops + DIV_OPS * div + TRIG_OPS * trig


def quat_ops(method: str) -> int:
    flops, rsqrt = QUAT_STEP[method]
    return flops + DIV_OPS * rsqrt


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
    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time, time_fn
    from bluerov2_dynamics_tpu_torch.models import fossen
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr

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

    def drive(phase, names, fn):
        """Run ``fn`` with the launch counts set to 0 just before and read
        just after; every kernel of ``names`` must have launched."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {n: _build.launches[n] for n in names}
        print(f"{phase}: launches {counts}")
        for n, c in counts.items():
            if c < 1:
                fail(f"kernel {n} was not launched on the {phase} path")
        launches.update(counts)
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
    act_ops = 8 * (CURVE_OPS + LAG_OPS) + 2 * nnz - 6
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
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device query")

    # 6. results ------------------------------------------------------------------
    src = "bluerov2_dynamics_tpu_torch/csrc/"
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
    ]
    kernels = []
    for name, source, replaces in kernels_meta:
        rtol, atol = TOL[name]
        entry = dict(name=name, route="cuda", source=src + source, replaces=replaces,
                     launches=launches[name], max_abs_err=err[name], max_abs_diff=err[name],
                     tol=dict(rtol=rtol, atol=atol), ms=ms[name], kernel_ms=ms[name],
                     plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                     bound_by=bounds[name][1], library_ms=None, shape=shapes[name])
        if name in large:
            entry["large"] = large[name]
        if name == "batched_rollout":
            entry["checked"] = (f"{B_ROLL - n_near} of {B_ROLL} trajectories; {n_near} near the "
                                f"gimbal singularity left out (max|kernel - plain| {near_diff:.3e})")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Closed-loop control demo: LQR hover / Koopman-LQR / trajectory opt.

Counterpart of ``bluerov2_dynamics_tpu/apps/control_demo.py``, with the same
tasks, default sizes and printed lines, against the full nonlinear
thruster-lag plant:

* ``hover``    — trim + exact-Jacobian linearization + Riccati LQR,
                 recovering a pose perturbation;
* ``koopman``  — LQR on the lifted (A, B) of an EDMDc model fitted to
                 episodic near-hover plant data;
* ``waypoint`` — direct trajectory optimization: Adam over a squashed
                 control sequence through the rollout;
* ``mpc``      — receding-horizon MPC from a near-reversed heading, vs the
                 LQR's wide swing (opt-in; not part of ``all``);
* ``mppi``     — sampling-based MPPI around a discontinuous keep-out-disk
                 cost, vs the obstacle-blind LQR (opt-in);
* ``lqg``      — output feedback: pose-only noisy mocap, an EKF in the loop,
                 vs raw-pose feedback and the true-state oracle (opt-in);
* ``adaptive`` — online adaptation of the Koopman-LQR to a reversed
                 half-strength thruster, vs the frozen policy (opt-in);
* ``los``      — LOS waypoint guidance over a 4-waypoint square with a
                 station-keeping hold (opt-in);
* ``ilqr``     — iterative LQR, then the plan executed with its
                 time-varying gains under an unseen current, vs open-loop
                 replay (opt-in).

Every loop runs as replays of CUDA graphs on the card
(``models/control.py``); the printed times are the card's (or the CPU's
with ``device="cpu"``), on the card including the graphs' capture.  The random draws
(the Koopman and adaptive tasks' episodes, the LQG noise, the MPPI samples,
the adaptive dither) come from seeded torch streams, not threefry.
``--media-dir DIR`` draws the tasks' top views there, named as the JAX
app names them (:func:`save_figure`).

Usage::

    python -m bluerov2_dynamics_tpu_torch.apps.control_demo [hover|koopman|waypoint|mpc|mppi|ilqr|adaptive|lqg|los|all]

and on the CPU through ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval.timing import time_fn
from bluerov2_dynamics_tpu_torch.models import control, fossen, guidance, koopman
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans
from bluerov2_dynamics_tpu_torch.ops.scan import scan
from bluerov2_dynamics_tpu_torch.utils.log import info, ok

DT = 0.02
X0_PERTURBED = (0.5, -0.4, 0.3, 0.1, 0.0, 0.6)  # x y z phi theta psi
MPPI_OBSTACLE = (0.75, 0.0, 0.3)   # (cx, cy, radius) keep-out cylinder
LOS_FIGURE_RADIUS = 0.15           # the LOS figure's circles, whatever accept_radius ran
LOS_WAYPOINTS = [[1.5, 0.0, 0.3], [1.5, 1.5, 0.5], [0.0, 1.5, 0.2],
                 [0.0, 0.0, 0.0]]
# stream tags of the demo's own draws (the episodes, k-means++ seeding, the
# naive LQG baseline's noise)
EPISODE_TAG, KMEANS_TAG, NAIVE_TAG = 24, 25, 26


def _where(device: torch.device) -> str:
    """Where a printed time was taken: the card's name and that the time
    includes the CUDA graphs' capture, or the CPU."""
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (incl. graph capture)"
    return "the CPU"


def _plant(device):
    p = fossen_params(device=device)
    cfg = thruster_config(device=device)
    return p, cfg, fossen.make_thruster_step(p, cfg, lag_params(DT, device=device), DT, "euler")


def _carry(x):
    return (x, torch.zeros((*x.shape[:-1], 8, 3), dtype=x.dtype, device=x.device))


def _get(c):
    return c[0]


def _state(device, **values):
    x = torch.zeros(12, device=device)
    for i, v in values.items():
        x[int(i[1:])] = v
    return x


def _perturbed_x0(device):
    x = torch.zeros(12, device=device)
    x[:6] = torch.as_tensor(X0_PERTURBED)
    return x


def _report(name, X, steps):
    e0 = float(torch.linalg.norm(X[0]))
    ef = float(torch.linalg.norm(X[-1]))
    ok(f"{name}: |x| {e0:.3f} -> {ef:.2e} over {steps * DT:.0f} s "
       f"({steps} steps)")
    return {"initial_norm": e0, "final_norm": ef}


def _np(t):
    return t.detach().cpu().numpy()


def run_hover(steps=600, device=None):
    """Trim -> linearize -> LQR -> close the loop on the lag plant."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    info("hover: trim + exact-Jacobian LQR on the nonlinear lag plant")
    (pol, _), t = time_fn(lambda: (control.fossen_lqr(p, cfg, DT), None), warmup=0)
    ok(f"trim + linearize + Riccati solved in {t:.2f} s on {_where(device)}; "
       f"hover command (vertical thrusters): {np.round(_np(pol.u_eq[4:]), 4).tolist()}")
    X, U = control.simulate_closed_loop(plant, pol, _carry(_perturbed_x0(device)), steps,
                                        get_state=_get)
    out = _report("LQR hover recovery", X, steps)
    out["X"], out["U"] = _np(X), _np(U)
    return out


def _episodes(plant, u_eq, n_episodes, ep_len, device):
    """Episodic excitation near hover: ``u_eq + 0.3 N(0, 1)`` commands
    (clipped) from ``0.3 N(0, 1)`` starts, drawn on the host from the
    ``(0, EPISODE_TAG)`` stream; returns the starts, the commands and the
    states after each command, ``(n_ep, ep_len, 12)``."""
    gen = control.stream(0, EPISODE_TAG, "cpu")
    dU = torch.randn((n_episodes, ep_len, 8), generator=gen).to(device)
    x0s = (0.3 * torch.randn((n_episodes, 12), generator=gen)).to(device)
    U_ep = torch.clamp(u_eq + 0.3 * dU, -1, 1)

    def body(c, inp):
        c = plant((c[0], c[1]), inp[0])
        return c, (c[0],)

    (X,) = scan(body, _carry(x0s), (U_ep.transpose(0, 1),))
    return x0s, U_ep, X.transpose(0, 1)


def run_koopman(steps=600, n_episodes=60, ep_len=100, n_rbfs=100, device=None):
    """Episodic excitation -> EDMDc fit -> lifted LQR -> closed loop."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    info(f"koopman: EDMDc on {n_episodes}x{ep_len} near-hover episodes, "
         "LQR on the lifted (A, B)")
    u_eq, _ = control.trim(p, cfg)
    _, U_ep, Xs = _episodes(plant, u_eq, n_episodes, ep_len, device)
    model, t_fit = time_fn(lambda: koopman.fit_multi(
        control.stream(1, KMEANS_TAG, device), list(Xs), list(U_ep), n_rbfs=n_rbfs,
        gamma=1.0, ridge=1e-6), warmup=0)
    pol, t_lqr = time_fn(lambda: control.koopman_dlqr(
        model, torch.zeros(12, device=device), u_eq=u_eq), warmup=0)
    ok(f"EDMDc fit {t_fit:.2f} s, lifted Riccati ({model.lift_dim}-dim) "
       f"{t_lqr:.2f} s on {_where(device)}")
    X, U = control.simulate_closed_loop(plant, pol, _carry(_perturbed_x0(device)), steps,
                                        get_state=_get)
    out = _report("Koopman-LQR hover recovery", X, steps)
    out["X"], out["U"] = _np(X), _np(U)
    out.update(fit_s=t_fit, lqr_s=t_lqr, lift_dim=model.lift_dim)
    return out


def run_mpc(sim_steps=300, device=None, stats=None):
    """Receding-horizon MPC from a near-reversed heading vs LQR."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    x0 = _state(device, x0=1.5, x1=0.5, x5=3.0)
    init = float(torch.linalg.norm(x0[:3]))
    info(f"mpc: receding horizon (60-step plan, 20 Adam iters/step, one "
         f"CUDA graph an iteration) from psi=3.0 rad, {init:.2f} m out")
    pol = control.fossen_lqr(p, cfg, DT)
    Xl, _ = control.simulate_closed_loop(plant, pol, _carry(x0), sim_steps, get_state=_get)
    (X, U), t = time_fn(lambda: control.simulate_mpc(
        plant, x0, torch.zeros(12, device=device), sim_steps=sim_steps, horizon=60,
        replan_iters=20, init_iters=150, lr=0.1, carry_init=_carry, get_state=_get,
        stats=stats), warmup=0)
    pm = torch.linalg.norm(X[:, :3], dim=1)
    pl = torch.linalg.norm(Xl[:, :3], dim=1)
    ok(f"MPC {t:.1f} s on {_where(device)}: pos err {init:.3f} -> "
       f"{float(pm[-1]):.3f}, max excursion {float(torch.max(pm)):.3f} "
       f"(monotone approach); LQR -> {float(pl[-1]):.3f} but swings to "
       f"{float(torch.max(pl)):.3f}")
    return {"X": _np(X), "U": _np(U), "X_lqr": _np(Xl),
            "max_excursion": float(torch.max(pm)),
            "lqr_max_excursion": float(torch.max(pl)), "seconds": t}


def run_mppi(sim_steps=400, n_samples=512, device=None, stats=None):
    """Sampling-based MPPI through a hard keep-out cylinder vs the
    obstacle-blind LQR: the obstacle cost is a discontinuous indicator
    (zero gradient almost everywhere), which the sampled rollouts price
    directly."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    x0 = _state(device, x0=1.5)
    cx, cy, radius = MPPI_OBSTACLE
    center = torch.as_tensor([cx, cy], device=device)

    def obstacle(x, u):
        d = torch.linalg.norm(x[..., :2] - center, dim=-1)
        return 200.0 * (d < radius).to(x.dtype)

    info(f"mppi: 4x{n_samples} sampled 60-step rollouts per replan "
         f"(one CUDA graph a round), hard indicator keep-out disk "
         f"r={radius} m sitting on the straight line to the target")
    pol = control.fossen_lqr(p, cfg, DT)
    Xl, _ = control.simulate_closed_loop(plant, pol, _carry(x0), sim_steps, get_state=_get)
    (X, U), t = time_fn(lambda: control.simulate_mppi(
        plant, x0, torch.zeros(12, device=device), sim_steps=sim_steps, horizon=60,
        n_samples=n_samples, sigma=0.15, temperature=0.01, init_rounds=20, replan_rounds=4,
        effort_weight=1e-2, extra_cost=obstacle, carry_init=_carry, get_state=_get, seed=1,
        stats=stats), warmup=0)
    dm = torch.linalg.norm(X[:, :2] - center, dim=1)
    dl = torch.linalg.norm(Xl[:, :2] - center, dim=1)
    ef = float(torch.linalg.norm(X[-1, :3]))
    ok(f"MPPI {t:.1f} s on {_where(device)}: min obstacle distance "
       f"{float(torch.min(dm)):.3f} m (radius {radius}); final pos err "
       f"{ef:.3f} m.  Obstacle-blind LQR cuts through at "
       f"{float(torch.min(dl)):.3f} m")
    return {"X": _np(X), "U": _np(U), "X_lqr": _np(Xl),
            "min_dist": float(torch.min(dm)), "lqr_min_dist": float(torch.min(dl)),
            "final_err": ef, "seconds": t}


def run_lqg(steps=600, sigma=5e-3, device=None):
    """Output-feedback hover recovery: the controller sees only a noisy
    6-dim pose; an EKF over the flattened 36-dim plant carry reconstructs
    the velocities and the 24 lag states, and the LQR acts on the
    posterior.  Baselines: the policy fed the raw noisy pose with zeroed
    velocities, and the true-state oracle."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    pol = control.fossen_lqr(p, cfg, DT)
    carry0 = _carry(_perturbed_x0(device))
    info(f"lqg: pose-only mocap (sigma={sigma * 1e3:.0f} mm/mrad), EKF on "
         f"the 36-dim carry in the loop, {steps} steps")
    res, t = time_fn(lambda: control.simulate_lqg(
        plant, pol, lambda x: x[:6], 1e-8, sigma ** 2, carry0, steps=steps, seed=0,
        get_state=_get), warmup=0)
    noise = sigma * torch.randn((steps, 6), generator=control.stream(0, NAIVE_TAG, device),
                                device=device)
    zeros6 = torch.zeros(6, device=device)

    def naive(c, inp):
        c = (c[0], c[1])
        u = pol(torch.cat([c[0][:6] + inp[0], zeros6]))
        c = plant(c, u)
        return c, (c[0],)

    (Xn,) = scan(naive, carry0, (noise,))
    Xo, _ = control.simulate_closed_loop(plant, pol, carry0, steps, get_state=_get)
    tail = steps // 4

    def _rms(X):
        return float(torch.sqrt(torch.mean(torch.sum(X[-tail:] ** 2, dim=1))))

    tail_lqg, tail_naive, tail_oracle = _rms(res.X), _rms(Xn), _rms(Xo)
    est_err = float(torch.sqrt(torch.mean(torch.sum((res.X_est[-tail:] - res.X[-tail:]) ** 2,
                                                    dim=1))))
    mean_nis = float(torch.mean(res.nis))
    ok(f"LQG {t:.1f} s on {_where(device)}: tail-RMS |x| = "
       f"{tail_lqg:.2e} vs naive raw-pose feedback {tail_naive:.2e} "
       f"({tail_naive / max(tail_lqg, 1e-30):.0f}x) and true-state oracle "
       f"{tail_oracle:.2e}; estimate error {est_err:.2e}, mean NIS "
       f"{mean_nis:.2f} (chi^2(6) expects 6)")
    return {"X": _np(res.X), "X_est": _np(res.X_est), "U": _np(res.U), "X_naive": _np(Xn),
            "X_oracle": _np(Xo), "tail_rms": tail_lqg, "naive_tail_rms": tail_naive,
            "oracle_tail_rms": tail_oracle, "est_err": est_err, "mean_nis": mean_nis,
            "seconds": t}


def run_adaptive(steps=1200, segment=100, n_episodes=40, ep_len=80, n_rbfs=60,
                 forgetting=0.99, dither=0.05, device=None):
    """Online adaptation to a plant change: vertical thruster 6 reversed
    at half strength.  The frozen lifted LQR (fitted on healthy data) keeps
    a large offset; the adaptive loop absorbs the closed-loop data into the
    forgetting-RLS EDMDc statistics, re-trims and re-solves its gains
    every ``segment`` steps (one CUDA graph a segment)."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    u_eq, _ = control.trim(p, cfg)
    info(f"adaptive: seeding EDMDc stats from {n_episodes}x{ep_len} "
         f"healthy near-hover episodes ({n_rbfs} RBFs)")
    x0s, U_ep, Xs = _episodes(plant, u_eq, n_episodes, ep_len, device)
    Xfull = torch.cat([x0s[:, None, :], Xs], dim=1)
    centers, _ = kmeans(Xfull.reshape(-1, 12), n_rbfs, iters=25,
                        generator=control.stream(1, KMEANS_TAG, device))
    stats0 = koopman.streaming_init(centers, 1.0, input_dim=8, dtype=torch.float32,
                                    device=device)
    for Xe, Ue in zip(Xfull, U_ep):
        stats0 = koopman.streaming_update_episode(stats0, Xe, Ue)
    gains = torch.as_tensor([1, 1, 1, 1, 1, -0.5, 1, 1], dtype=torch.float32, device=device)

    def plant_damaged(c, u):
        return plant(c, u * gains)

    carry0 = _carry(_state(device, x0=0.4, x2=0.25, x5=0.4))
    info("adaptive: thruster 6 reversed at half strength from t=0; "
         f"refit+retrim+Riccati every {segment} steps "
         f"(lam={forgetting}, dither={dither})")
    pol_frozen = control.koopman_dlqr(koopman.streaming_finalize(stats0, 1e-6),
                                      torch.zeros(12, device=device), u_eq=u_eq)
    Xf, _ = control.simulate_closed_loop(plant_damaged, pol_frozen, carry0, steps, get_state=_get)
    res, t = time_fn(lambda: control.simulate_adaptive_koopman_lqr(
        plant_damaged, carry0, stats0, torch.zeros(12, device=device), u_eq, steps=steps,
        segment=segment, forgetting=forgetting, dither=dither, seed=2, get_state=_get),
        warmup=0)
    tail = steps // 4
    tail_frozen = float(torch.sqrt(torch.mean(torch.sum(Xf[-tail:] ** 2, dim=1))))
    tail_ad = float(torch.sqrt(torch.mean(torch.sum(res.X[-tail:] ** 2, dim=1))))
    ok(f"adaptive loop {t:.1f} s on {_where(device)}: tail-RMS |x| "
       f"over the last {tail} steps = {tail_ad:.3f} vs frozen lifted LQR "
       f"{tail_frozen:.3f} ({tail_frozen / max(tail_ad, 1e-9):.0f}x); "
       f"re-trimmed command on the damaged thruster "
       f"{float(res.u_eq[5]):+.3f} (healthy trim {float(u_eq[5]):+.3f}), "
       f"gain churn settles at {float(res.gain_deltas[-1]):.3f}")
    return {"X": _np(res.X), "U": _np(res.U), "X_frozen": _np(Xf),
            "tail_rms": tail_ad, "frozen_tail_rms": tail_frozen,
            "gain_deltas": _np(res.gain_deltas), "u_eq": _np(res.u_eq), "seconds": t}


def run_waypoint(horizon=250, opt_steps=250, device=None, stats=None):
    """Direct trajectory optimization through the lag plant."""
    device = resolve_device(device)
    _, _, plant = _plant(device)
    target = _state(device, x0=1.0, x1=0.5, x2=-0.3)
    info(f"waypoint: Adam over {horizon}x8 squashed controls through the "
         f"rollout -> ({float(target[0])}, {float(target[1])}, "
         f"{float(target[2])}) m in {horizon * DT:.0f} s")
    stats = {} if stats is None else stats
    res, t = time_fn(lambda: control.trajopt(
        plant, torch.zeros(12, device=device), target, horizon=horizon, steps=opt_steps,
        lr=0.05, carry_init=_carry, get_state=_get, stats=stats), warmup=0)
    err = float(torch.linalg.norm(res.X[-1, :3] - target[:3]))
    replay = (f"; an iteration replayed in {stats['replay_ms']:.2f} ms (capture "
              f"{stats['capture_s']:.2f} s)" if "replay_ms" in stats else "")
    ok(f"trajopt: loss {float(res.losses[0]):.3e} -> "
       f"{float(res.losses[-1]):.3e} in {t:.2f} s on {_where(device)}{replay}; "
       f"terminal position error {err:.2e} m")
    return {"X": _np(res.X), "U": _np(res.U), "terminal_error": err,
            "losses": _np(res.losses), "seconds": t}


def run_los(steps=4000, accept_radius=0.15, lookahead=0.6, cruise_speed=0.25, device=None):
    """LOS waypoint mission: outer guidance + hover-LQR inner loop."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    info(f"los: {len(LOS_WAYPOINTS)}-waypoint square at "
         f"{cruise_speed} m/s cruise, lookahead {lookahead} m, "
         f"acceptance {accept_radius} m — one {steps}-step loop")
    pol = control.fossen_lqr(p, cfg, DT)
    plan = guidance.make_plan([0, 0, 0], LOS_WAYPOINTS, accept_radius=accept_radius,
                              lookahead=lookahead, cruise_speed=cruise_speed, device=device)
    res, t = time_fn(lambda: guidance.simulate_los_mission(
        plant, pol, plan, _carry(torch.zeros(12, device=device)), steps, get_state=_get),
        warmup=0)
    s = guidance.mission_summary(res, plan)
    hits = ", ".join(
        f"wp{i + 1} @ {h * DT:.1f} s (closest {d:.3f} m)"
        for i, (h, d) in enumerate(zip(s["hit_step"], s["min_dist"])))
    ok(f"mission {t:.1f} s on {_where(device)}: all waypoints hit = "
       f"{s['all_hit']} [{hits}]; cross-track RMS "
       f"{s['cross_track_rms'] * 100:.1f} cm in transit; station-keeping "
       f"error at the final waypoint {s['final_pos_err'] * 100:.2f} cm")
    return {"X": _np(res.X), "U": _np(res.U), "wp_index": _np(res.wp_index),
            "cross_track": _np(res.cross_track),
            **{k: s[k] for k in ("all_hit", "final_pos_err", "cross_track_rms")},
            "min_dist": np.asarray(s["min_dist"]), "hit_step": np.asarray(s["hit_step"]),
            "seconds": t}


def run_ilqr(horizon=250, iters=10, current=(0.12, -0.08, 0.0), device=None):
    """iLQR waypoint plan + time-varying-LQR execution under an unseen
    current: the backward pass' gains absorb it, while open-loop replay of
    the same controls (gains zeroed) is blown off course."""
    device = resolve_device(device)
    p, cfg, plant = _plant(device)
    target = _state(device, x0=1.0, x1=0.5, x2=-0.3)
    info(f"ilqr: {iters} second-order sweeps over a {horizon}x8 squashed "
         f"plan (batched linearization + Riccati backward pass + "
         f"parallel line search, one CUDA graph a sweep)")
    res, t = time_fn(lambda: control.ilqr(
        plant, torch.zeros(12, device=device), target, horizon=horizon, iters=iters,
        effort_weight=1e-3, carry_init=_carry, get_state=_get), warmup=0)
    err_plan = float(torch.linalg.norm(res.X[-1, :3] - target[:3]))
    ok(f"ilqr: cost {float(res.costs[0]):.2f} -> {float(res.costs[-1]):.2f} "
       f"in {iters} sweeps, {t:.2f} s on {_where(device)}; planned "
       f"terminal position error {err_plan:.2e} m")
    true_plant = fossen.make_thruster_step(fossen_params(current=current, device=device), cfg,
                                           lag_params(DT, device=device), DT, "euler")
    carry0 = _carry(torch.zeros(12, device=device))
    Xo, _ = control.simulate_tvlqr(true_plant, res._replace(K=torch.zeros_like(res.K)), carry0,
                                   get_state=_get)
    Xc, _ = control.simulate_tvlqr(true_plant, res, carry0, get_state=_get)
    err_open = float(torch.linalg.norm(Xo[-1, :3] - target[:3]))
    err_fb = float(torch.linalg.norm(Xc[-1, :3] - target[:3]))
    ok(f"executed under unseen current {current}: open-loop replay misses "
       f"by {err_open:.3f} m, time-varying-gain execution by "
       f"{err_fb:.3f} m ({err_open / max(err_fb, 1e-9):.1f}x)")
    return {"X": _np(Xc), "U": _np(res.U), "X_open": _np(Xo), "X_plan": _np(res.X),
            "plan_error": err_plan, "open_loop_error": err_open,
            "feedback_error": err_fb, "costs": _np(res.costs), "seconds": t}


def main(argv=None, device=None):
    """The demo CLI; ``device=None`` means ``cuda``.  Returns the tasks'
    results keyed by task."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("task", nargs="?", default="all",
                    choices=["hover", "koopman", "waypoint", "mpc", "mppi",
                             "ilqr", "adaptive", "lqg", "los", "all"])
    ap.add_argument("--steps", type=int, default=600,
                    help="closed-loop steps for the hover tasks")
    ap.add_argument("--media-dir", type=str, default=None,
                    help="save a top-view trajectory figure here")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    out = {}
    if args.task in ("hover", "all"):
        out["hover"] = run_hover(args.steps, device=device)
    if args.task in ("koopman", "all"):
        out["koopman"] = run_koopman(args.steps, device=device)
    if args.task in ("waypoint", "all"):
        out["waypoint"] = run_waypoint(device=device)
    if args.task == "mpc":
        out["mpc"] = run_mpc(device=device)
    if args.task == "mppi":
        out["mppi"] = run_mppi(device=device)
    if args.task == "ilqr":
        out["ilqr"] = run_ilqr(device=device)
    if args.task == "adaptive":
        out["adaptive"] = run_adaptive(device=device)
    if args.task == "lqg":
        out["lqg"] = run_lqg(device=device)
    if args.task == "los":
        out["los"] = run_los(device=device)
    if args.media_dir:
        save_figure(args.task, out, args.media_dir)
    ok("done")
    return out


def save_figure(task: str, out: dict, media_dir: str) -> str:
    """The JAX app's top-view figure of ``task``'s results (host arrays):
    a single task under its own name, so that a one-task run never
    overwrites the 3-task ``all`` figure.  The LOS figure draws each
    waypoint's acceptance circle at a fixed 0.15 m, as the JAX app does,
    whatever ``accept_radius`` the mission ran with.  Returns the path."""
    from bluerov2_dynamics_tpu_torch.viz import plot_topdown_with_depth

    obstacles = None
    if task == "mpc":
        # MPC's story is the PATH vs the saturated LQR's swing
        trajs = {"MPC": out["mpc"]["X"], "LQR": out["mpc"]["X_lqr"]}
        name = "control_demo_mpc_2D.png"
        title = "Receding-horizon MPC vs saturated LQR from psi=3.0 rad (top view)"
    elif task == "mppi":
        trajs = {"MPPI": out["mppi"]["X"], "LQR": out["mppi"]["X_lqr"]}
        name = "control_demo_mppi_2D.png"
        title = "MPPI vs obstacle-blind LQR (keep-out disk)"
        obstacles = [MPPI_OBSTACLE]
    elif task == "ilqr":
        trajs = {"TVLQR": out["ilqr"]["X"], "OPEN-LOOP": out["ilqr"]["X_open"],
                 "PLAN": out["ilqr"]["X_plan"]}
        name = "control_demo_ilqr_2D.png"
        title = ("iLQR plan under an unseen current: time-varying "
                 "gains vs open-loop replay (top view)")
    elif task == "lqg":
        trajs = {"LQG": out["lqg"]["X"], "NAIVE": out["lqg"]["X_naive"],
                 "ORACLE": out["lqg"]["X_oracle"]}
        name = "control_demo_lqg_2D.png"
        title = ("Output-feedback LQG (pose-only noisy mocap) vs "
                 "naive raw-pose feedback (top view)")
    elif task == "los":
        trajs = {"LOS": out["los"]["X"]}
        name = "control_demo_los_2D.png"
        title = "LOS waypoint mission: lookahead guidance + hover-LQR inner loop (top view)"
        obstacles = [(wx, wy, LOS_FIGURE_RADIUS) for wx, wy, _ in LOS_WAYPOINTS]
    elif task == "adaptive":
        trajs = {"ADAPTIVE": out["adaptive"]["X"], "FROZEN": out["adaptive"]["X_frozen"]}
        name = "control_demo_adaptive_2D.png"
        title = ("Adaptive Koopman-LQR vs frozen lifted LQR under "
                 "thruster damage (top view)")
    elif task == "all":
        trajs = {k.upper(): v["X"] for k, v in out.items()}
        name = "control_demo_2D.png"
        title = ("Closed-loop control: LQR / Koopman-LQR hover "
                 "recovery + trajopt waypoint (top view)")
    else:
        trajs = {task.upper(): out[task]["X"]}
        name = f"control_demo_{task}_2D.png"
        title = f"Closed-loop control: {task} task (top view)"
    return plot_topdown_with_depth(
        trajs, dt=DT, seconds=len(next(iter(trajs.values()))) * DT,
        save_path=f"{media_dir}/{name}", title=title, obstacles=obstacles,
    )


if __name__ == "__main__":
    main()

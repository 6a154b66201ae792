"""State-estimation workload: filter a noisy recording with the physics
EKF/UKF (+ optional RTS smoother and ML noise identification).

Counterpart of ``bluerov2_dynamics_tpu/apps/estimate.py``, with the same
arguments, checks and JSON record:

1. the recorded thruster commands become the applied wrench of each step
   (``thrusters.effective_wrench_history``, the lag run once over the
   commands; its time is printed);
2. an EKF (exact Jacobians of the Fossen wrench step), a UKF, the particle
   filter (``--filter pf``), MHE (``--filter mhe``) or the lifted Koopman
   filter (``--filter koopman``) filters the recording; ``--smooth`` adds
   the RTS backward pass; ``--contract quat`` runs the multiplicative EKF
   on quat13 states (and the manifold RTS);
3. ``--fit-noise`` identifies diagonal Q/R by maximum likelihood first,
   on a bank of segments (one CUDA graph an Adam iteration on the card);
4. ``--fossen-fit`` calibrates the plant coefficients first;
5. ``--refit-koopman`` fits Koopman on raw and on filtered training states
   and scores both on the noise-free truth (synthetic data only).

Every step loop runs as replays of CUDA graphs on the card
(``models/estimation.py``).  Unless ``--no-media``, a figure of four
channels (raw, filtered, smoothed; errors against the truth where it is
known) goes to ``<media-dir>``, named as the JAX app names it
(:func:`_save_figure`).

Run on the card::

    python -m bluerov2_dynamics_tpu_torch.apps.estimate --synthetic --recording \\
        --steps 45823 --smooth --fit-noise --fossen-fit --refit-koopman --no-media

and on the CPU through ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.apps.common import (
    add_sysid_args,
    base_parser,
    fit_fossen_from_args,
    json_sanitize,
)
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval.timing import sync, time_fn
from bluerov2_dynamics_tpu_torch.models import estimation, fossen
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.models.thrusters import effective_wrench_history
from bluerov2_dynamics_tpu_torch.ops import scan
from bluerov2_dynamics_tpu_torch.utils.log import info, ok, warn

# per-channel-group sensor-noise scales (pos, ang, vel, angvel) matching
# the pseudo recording generator's defaults (data/synthetic.py)
DEFAULT_R_SCALES = (1e-3, 2e-3, 1e-3, 2e-3)
GROUPS = (("position", 0, 3), ("attitude", 3, 6),
          ("lin. velocity", 6, 9), ("ang. velocity", 9, 12))
MHE_MAX_ROWS = 800


def build_parser():
    ap = base_parser(
        "Filter a (noisy) thruster-contract recording with the physics "
        "EKF/UKF; optional RTS smoothing, ML noise identification, plant "
        "calibration, and a raw-vs-filtered Koopman refit comparison.")
    g = ap.add_argument_group("estimation")
    g.add_argument("--contract", choices=("thruster", "quat"), default="thruster",
                   help="dataset contract: 'thruster' = euler12 states + u1..u8 commands "
                        "(EKF/UKF/PF/MHE/lifted-KF filters); 'quat' = quat13 states + "
                        "wrench inputs, filtered by the multiplicative EKF "
                        "(estimation.mekf_quat13)")
    g.add_argument("--filter", choices=("ekf", "ukf", "pf", "mhe", "koopman"), default="ekf",
                   help="forward filter (ekf: exact Jacobians; ukf: sigma points; pf: "
                        "bootstrap particle filter; mhe: moving-horizon estimation with an "
                        "optional Huber penalty; koopman: the exact linear KF on the lifted "
                        "system of an EDMDc model fitted to the training split)")
    g.add_argument("--pf-particles", type=int, default=1024,
                   help="ensemble size for --filter pf")
    g.add_argument("--mhe-window", type=int, default=20,
                   help="--filter mhe: sliding window length")
    g.add_argument("--mhe-iters", type=int, default=20,
                   help="--filter mhe: Adam iterations per window from the shifted warm "
                        "start (the first window gets 20x this)")
    g.add_argument("--mhe-meas-loss", choices=("quadratic", "huber"), default="huber",
                   help="--filter mhe: measurement penalty ('huber' bounds the pull of "
                        "impulsive outliers)")
    g.add_argument("--outlier-frac", type=float, default=0.0,
                   help="synthetic only: corrupt this fraction of sensor samples with "
                        "impulsive +-(--outlier-sigma)-sigma glitches after generation")
    g.add_argument("--outlier-sigma", type=float, default=50.0,
                   help="outlier magnitude in per-channel sigmas")
    g.add_argument("--koopman-q", type=float, default=1e-6,
                   help="lifted-space process-noise scale for --filter koopman")
    g.add_argument("--smooth", action="store_true",
                   help="add the RTS backward pass (ekf; for --contract quat the "
                        "manifold/tangent-space variant)")
    g.add_argument("--measure", choices=("all", "pose"), default="all",
                   help="measured channels: 'all' = the full recorded state; 'pose' = "
                        "position+attitude only (the velocities are estimated)")
    g.add_argument("--q", type=float, default=1e-6,
                   help="process-noise variance (isotropic diagonal)")
    g.add_argument("--r-scales", type=float, nargs=4, default=list(DEFAULT_R_SCALES),
                   metavar=("POS", "ANG", "VEL", "ANGVEL"),
                   help="measurement-noise standard deviations per channel group "
                        "(default: the pseudo recording's generator values)")
    g.add_argument("--p0", type=float, default=1e-2,
                   help="prior covariance scale (isotropic)")
    g.add_argument("--fit-noise", action="store_true",
                   help="identify diagonal Q/R by maximum likelihood before filtering "
                        "(estimation.fit_noise)")
    g.add_argument("--fit-noise-window", type=int, default=4000,
                   help="recording prefix length the ML noise fit runs on")
    g.add_argument("--fit-noise-steps", type=int, default=200)
    g.add_argument("--fit-noise-lr", type=float, default=0.15)
    g.add_argument("--fit-noise-seglen", type=int, default=250,
                   help="the fit window is cut into contiguous segments of this length "
                        "and filtered as a bank (estimation.segment_trajectory); 0 = one "
                        "unsegmented window")
    g.add_argument("--no-lag", action="store_true",
                   help="drive the filter plant with the static thruster curve instead of "
                        "the lag-filtered wrench history")
    g.add_argument("--refit-koopman", action="store_true",
                   help="fit Koopman on raw vs filtered training states and score both on "
                        "the noise-free truth (synthetic data only)")
    g.add_argument("--out-csv", type=str, default=None,
                   help="write the filtered (or smoothed) states + inputs as a CSV in the "
                        "run's contract (thruster or quat13/wrench)")
    g.add_argument("--json-out", type=str, default=None, help="write a JSON run record")
    add_sysid_args(ap)
    return ap


def _group_rmse(A, B):
    """Per-channel-group RMSE dict between (N, 12) arrays."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    out = {name: float(np.sqrt(np.mean((A[:, lo:hi] - B[:, lo:hi]) ** 2)))
           for name, lo, hi in GROUPS}
    out["all"] = float(np.sqrt(np.mean((A - B) ** 2)))
    return out


def _print_rmse_table(rows):
    """rows: name -> group-RMSE dict."""
    names = list(rows)
    header = "  Signal                |" + "|".join(f" {n:>12} " for n in names)
    print("\n[metrics] RMSE vs noise-free truth:")
    print(header)
    print("  " + "-" * (len(header) - 2))
    for gname, _, _ in GROUPS:
        print(f"  {gname:<21} |" + "|".join(f" {rows[n][gname]:>12.6f} " for n in names))
    print(f"  {'all channels':<21} |" + "|".join(f" {rows[n]['all']:>12.6f} " for n in names))


def _write(path, text: str, what: str):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    ok(f"Wrote {what} -> {path}")


def _write_csv(path, cols, data, what: str):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, data, delimiter=",", comments="", header=",".join(cols))
    ok(f"Wrote {what} -> {path}")


def _timed(fn):
    """One completion-forced call of ``fn``: ``(result, cold_s, warm_s)``.
    ``cold`` is the call's host seconds, the CUDA graphs' warm-up and
    capture included; ``warm`` the same less those (``ops.scan.STATS``):
    the replays alone, the counterpart of the JAX app's second call, which
    skips the compile.  On the CPU (no graph) the two are equal."""
    before = scan.STATS["capture_s"]
    res, cold = time_fn(fn, warmup=0)
    return res, cold, cold - (scan.STATS["capture_s"] - before)


def _host(t):
    return t.double().cpu().numpy()


def _wrench_history(cfg, lag, U, use_lag: bool):
    """The applied wrench of every row, timed (completion-forced)."""
    t0 = time.perf_counter()
    TAU = sync(effective_wrench_history(cfg, lag, U, use_lag=use_lag))
    seconds = time.perf_counter() - t0
    ok(f"Wrench history over {U.shape[0]} rows in {seconds:.3f} s")
    return TAU, seconds


DEFAULT_FIG_CHANS = ((2, "z", "m"), (5, "psi", "rad"),
                     (6, "u", "m/s"), (11, "r", "rad/s"))


def _save_figure(path, dt, X, X_filt, X_sm, X_true, diag_text,
                 seconds=20.0, t0_frac=0.4, chans=DEFAULT_FIG_CHANS):
    """One panel per channel group on a zoomed window: truth (if
    available), raw sensor, filtered, smoothed; the filter's consistency
    diagnostic (``diag_text``: NIS for the Kalman family, ESS for the
    PF) in the title.  ``chans``: (column, name, unit) per panel.  Host
    arrays only; matplotlib is imported here, on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    N = X.shape[0]
    w = min(int(seconds / max(dt, 1e-9)), N)
    s = int(t0_frac * (N - w))
    t = (np.arange(s, s + w) - s) * dt
    errors = X_true is not None
    fig, axes = plt.subplots(2, 2, figsize=(10, 6), dpi=150, sharex=True)
    for ax, (c, name, unit) in zip(axes.ravel(), chans):
        # with ground truth, plot the ERRORS: the filter's value is
        # invisible on overlapping traces at mocap noise scales
        ref = X_true[s:s + w, c] if errors else 0.0
        ax.plot(t, X[s:s + w, c] - ref, ".", ms=2, color="0.65",
                label="raw sensor")
        ax.plot(t, X_filt[s:s + w, c] - ref, lw=1.0, label="filtered")
        if X_sm is not None:
            ax.plot(t, X_sm[s:s + w, c] - ref, lw=1.0, ls="--",
                    label="smoothed")
        if errors:
            ax.axhline(0.0, color="k", lw=0.6)
            ax.set_ylabel(f"{name} error [{unit}]")
        else:
            ax.set_ylabel(f"{name} [{unit}]")
        ax.grid(alpha=0.3)
    for ax in axes[1]:
        ax.set_xlabel("t [s]")
    axes[0, 0].legend(loc="best", fontsize=8)
    kind = "error vs truth" if errors else "estimates"
    fig.suptitle(f"State estimation on the recording ({kind}) — "
                 f"{diag_text}")
    fig.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    ok(f"Wrote estimation figure -> {path}")


def _main_quat(args, device):
    """The quat13/wrench contract, filtered by the multiplicative EKF;
    the accuracy table is in the tangent space (position, attitude
    rotation vector, velocities via ``quat13_boxminus``)."""
    def to_quat13(X12):
        q = csv_loader.euler_to_quat_np(X12[:, 3], X12[:, 4], X12[:, 5])
        return np.concatenate([X12[:, 0:3], q, X12[:, 6:12]], axis=1).astype(np.float32)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    record = {}
    if args.synthetic or args.csv is None:
        ds, X_true12, delay = common.load_or_generate_with_truth(args, device=device)
        X, X_true = to_quat13(ds.X), to_quat13(X_true12)
        cfg, lag = thruster_config(device=device), lag_params(ds.dt, device=device)
        TAU, record["wrench_history_s"] = _wrench_history(cfg, lag, f32(ds.U),
                                                          not args.no_lag)
    else:
        ds = common.load_or_generate(args, csv_loader.load_quat_dataset, device)
        X, X_true, delay = np.asarray(ds.X, np.float32), None, 0
        TAU = f32(ds.U)
    N, dt = X.shape[0], float(ds.dt)
    info(f"Dataset (quat13/wrench): {N} rows @ dt={dt:.4f} (input delay {delay})")
    record.update({"n_rows": N, "dt": dt, "filter": "mekf_quat13"})

    p = fossen_params(device=device)
    n_tr = int(args.train_split * N)
    sysid_res, record["fossen_fit_s"] = fit_fossen_from_args(
        args, f32(X[:n_tr]), TAU[:n_tr], dt, kind="wrench", state="quat13")
    if sysid_res is not None:
        p = sysid_res.params
    record["plant"] = "fitted" if sysid_res is not None else "nominal"

    step = fossen.make_wrench_step(p, dt, "euler", "quat13")
    r_diag = np.repeat(np.asarray(args.r_scales, np.float64) ** 2, 3)
    Q = torch.eye(12, device=device) * args.q
    R = f32(np.diag(r_diag))
    P0 = torch.eye(12, device=device) * args.p0
    Y = f32(X)
    TAU_trans = TAU[delay:delay + N - 1]

    res, cold, warm = _timed(
        lambda: estimation.mekf_quat13(step, Q, R, Y[0], P0, TAU_trans, Y))
    nis_mean = float(torch.mean(res.nis))
    ok(f"MEKF (quat13) over {N} steps: warm {warm:.4f} s (cold incl. graph capture "
       f"{cold:.2f} s); loglik {float(res.loglik):.1f}, mean NIS {nis_mean:.2f} "
       f"(chi^2 expectation 12)")
    record.update({"loglik": float(res.loglik), "nis_mean": nis_mean,
                   "filter_warm_s": warm, "filter_cold_s": cold})
    norms = np.linalg.norm(_host(res.means)[:, 3:7], axis=-1)
    record["quat_norm_max_dev"] = float(np.max(np.abs(norms - 1.0)))
    if not np.allclose(norms, 1.0, atol=1e-5):
        warn(f"quaternion norm drift: max |1-||q||| = {record['quat_norm_max_dev']:.2e}")

    sm = None
    if args.smooth:
        sm, cold_s, warm_s = _timed(
            lambda: estimation.manifold_rts_smooth(step, Q, TAU_trans, res,
                                                   boxplus=estimation.quat13_boxplus,
                                                   boxminus=estimation.quat13_boxminus))
        ok(f"Manifold RTS smoother backward pass: warm {warm_s:.4f} s (cold {cold_s:.2f} s)")
        record.update({"smooth_warm_s": warm_s, "smooth_cold_s": cold_s})
    X_best = _host(sm.means if sm is not None else res.means)

    if X_true is not None:
        Xt = f32(X_true)
        err = lambda A: _host(estimation.quat13_boxminus(A, Xt))  # noqa: E731
        err_r = err(Y)
        zero = 0.0 * err_r
        rows = {"raw sensor": _group_rmse(err_r, zero), "MEKF": _group_rmse(err(res.means), zero)}
        if sm is not None:
            rows["RTS smoothed"] = _group_rmse(err(sm.means), zero)
        _print_rmse_table(rows)
        record["rmse_vs_truth"] = rows
    else:
        info("No ground truth available (real CSV) — NIS/loglik are the consistency "
             "diagnostics.")

    if not args.no_media:
        if X_true is not None:
            try:
                _save_figure(
                    Path(args.media_dir) / "estimate_quat_channels.png",
                    dt, err(Y), err(res.means),
                    err(sm.means) if sm is not None else None,
                    np.zeros((N, 12), np.float32),   # errors around zero
                    f"mean NIS {nis_mean:.2f} (chi^2 expectation 12)",
                    chans=((2, "z", "m"), (5, "rotvec-z (yaw)", "rad"),
                           (6, "u", "m/s"), (11, "r", "rad/s")))
            except ImportError:
                warn("matplotlib unavailable — skipping the estimation figure")
        else:
            info("estimation figure needs ground truth for the tangent-space error view "
                 "— skipped on real CSV data")

    if args.out_csv:
        _write_csv(args.out_csv, ["t"] + csv_loader.QUAT13_COLS + csv_loader.WRENCH_COLS,
                   np.column_stack([np.asarray(ds.t, np.float64), X_best, _host(TAU)]),
                   "filtered quat13-contract CSV")
    if args.json_out:
        _write(args.json_out, json.dumps(json_sanitize(record), indent=2), "JSON run record")
    return record


def _validate(args):
    """The argv-only checks, in the JAX app's order, before any work."""
    if args.smooth and args.filter != "ekf":
        raise SystemExit("--smooth composes with --filter ekf")
    if args.filter == "mhe" and args.steps > MHE_MAX_ROWS and (
            args.synthetic or args.csv is None):
        raise SystemExit(
            f"--filter mhe runs iters x window sequential optimisation steps per sample; "
            f"more than {MHE_MAX_ROWS} synthetic rows is refused, as in the JAX app.  Run a "
            f"shorter --steps slice, or mhe over estimation.segment_trajectory segments for "
            f"long records.")
    if args.outlier_frac > 0.0 and not (args.synthetic or args.csv is None):
        raise SystemExit("--outlier-frac corrupts SYNTHETIC sensors (real CSVs carry "
                         "whatever glitches they carry); run with --synthetic")
    if args.filter == "koopman":
        if args.measure == "pose":
            raise SystemExit("--filter koopman needs --measure all (the lifted KF measures "
                             "through the full-state readout)")
        if getattr(args, "fossen_fit", False):
            raise SystemExit("--filter koopman ignores the calibrated physics plant (the "
                             "lifted model is fitted from data); drop --fossen-fit")
    if args.refit_koopman and not (args.synthetic or args.csv is None):
        raise SystemExit("--refit-koopman needs ground truth; run with --synthetic "
                         "[--recording]")
    if args.contract == "quat":
        for flag, name in ((args.fit_noise, "--fit-noise"),
                           (args.refit_koopman, "--refit-koopman"),
                           (args.measure == "pose", "--measure pose"),
                           (args.filter != "ekf", f"--filter {args.filter}")):
            if flag:
                raise SystemExit(f"{name} is not supported with --contract quat (this "
                                 f"contract always runs the MEKF; leave --filter at its "
                                 f"default)")


def _inject_outliers(args, X):
    rng_o = np.random.default_rng(args.seed + 1)
    sig_groups = np.repeat(
        np.asarray(args.r_scales, np.float64)
        * (args.noise_scale if tuple(args.r_scales) == DEFAULT_R_SCALES else 1.0), 3)
    mask = rng_o.random(X.shape) < args.outlier_frac
    X = X + np.where(mask, args.outlier_sigma * sig_groups
                     * np.sign(rng_o.standard_normal(X.shape)), 0.0).astype(X.dtype)
    info(f"Injected impulsive outliers: {mask.mean():.1%} of samples at "
         f"+-{args.outlier_sigma:g} sigma")
    return X


def main(argv=None, device=None):
    """The estimation workload; ``device=None`` means ``cuda``.  Returns the
    JSON run record (a dict)."""
    args = build_parser().parse_args(argv)
    _validate(args)
    device = resolve_device(device)
    if args.contract == "quat":
        return _main_quat(args, device)

    ds, X_true, delay = common.load_or_generate_with_truth(args, device=device)
    X, U = np.asarray(ds.X, np.float32), np.asarray(ds.U, np.float32)
    X_true = None if X_true is None else np.asarray(X_true, np.float32)
    t_stamps, dt = np.asarray(ds.t, np.float64), ds.dt
    N = X.shape[0]
    info(f"Dataset: {N} rows @ dt={dt:.4f} (input delay {delay})")
    if args.outlier_frac > 0.0:
        X = _inject_outliers(args, X)
    record = {"n_rows": N, "dt": dt, "filter": args.filter}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    X_d, U_d = f32(X), f32(U)

    # ---- plant: nominal or sysid-calibrated physics --------------------
    p = fossen_params(device=device)
    cfg = thruster_config(device=device)
    lag = lag_params(dt, device=device)
    n_tr = int(args.train_split * N)
    sysid_res, record["fossen_fit_s"] = fit_fossen_from_args(args, X_d[:n_tr], U_d[:n_tr], dt)
    if sysid_res is not None:
        p, cfg = sysid_res.params, sysid_res.cfg
    record["plant"] = "fitted" if sysid_res is not None else "nominal"

    # ---- exact wrench inputs from the command history ------------------
    TAU, record["wrench_history_s"] = _wrench_history(cfg, lag, U_d, not args.no_lag)
    TAU_trans = TAU[delay:delay + N - 1]                            # (N-1, 6)
    step = fossen.make_wrench_step(p, dt, "euler", "euler12")
    pose_only = args.measure == "pose"
    m_dim = 6 if pose_only else 12
    h = (lambda x: x[:6]) if pose_only else (lambda x: x)

    # ---- noise model ----------------------------------------------------
    r_scales = np.asarray(args.r_scales, np.float64)
    if (args.noise_scale != 1.0 and (args.synthetic or args.csv is None)
            and tuple(args.r_scales) == DEFAULT_R_SCALES):
        # the defaults mirror the generator's sigmas: keep them matched
        r_scales = r_scales * args.noise_scale
        info(f"--noise-scale {args.noise_scale:g}: default R sigmas scaled to match the "
             f"generator")
    r_diag = np.repeat(r_scales ** 2, 3)[:m_dim]
    Q = torch.eye(12, device=device) * args.q
    R = f32(np.diag(r_diag))
    P0 = torch.eye(12, device=device) * args.p0
    Y = X_d[:, :m_dim]
    if pose_only:
        # unmeasured velocities: zero prior mean, loose prior variance
        P0[6:, 6:] = torch.eye(6, device=device) * 0.25
        m0 = torch.cat([Y[0], torch.zeros(6, device=device)])
        info("Measuring position+attitude only — velocities are estimated, never observed")
    else:
        m0 = Y[0]

    if args.fit_noise:
        W = min(args.fit_noise_window, N)
        L = args.fit_noise_seglen
        if L and W // L >= 2:
            m0_f, U_f, Y_f = estimation.segment_trajectory(TAU_trans[:W - 1], Y[:W], L)
            if pose_only:
                # segment priors: measured pose, zero-velocity mean
                m0_f = torch.cat([m0_f, torch.zeros((m0_f.shape[0], 6), device=device)], dim=1)
            info(f"ML noise identification on the first {W} rows as a {U_f.shape[0]}x{L}-"
                 f"segment bank ({args.fit_noise_steps} Adam steps)...")
        else:
            m0_f, U_f, Y_f = m0, TAU_trans[:W - 1], Y[:W]
            info(f"ML noise identification on the first {W} rows "
                 f"({args.fit_noise_steps} Adam steps)...")
        stats = {}
        fit, t_fit = time_fn(
            lambda: estimation.fit_noise(step, h, m0_f, P0, U_f, Y_f, q0=args.q,
                                         r0=r_diag.astype(np.float32),
                                         steps=args.fit_noise_steps, lr=args.fit_noise_lr,
                                         stats=stats),
            warmup=0)
        Q, R = fit.Q, fit.R
        log_q, log_r = _host(fit.log_q), _host(fit.log_r)
        q_grp = {g: float(np.sqrt(np.mean(np.exp(log_q)[lo:hi]))) for g, lo, hi in GROUPS}
        r_grp = {g: float(np.sqrt(np.mean(np.exp(log_r)[lo:hi])))
                 for g, lo, hi in GROUPS if hi <= m_dim}
        losses = _host(fit.losses)
        replay = (f"; graph capture {stats['capture_s']:.2f} s, {stats['replay_ms']:.2f} ms "
                  f"an iteration replayed" if stats else "")
        ok(f"Noise fitted in {t_fit:.2f} s{replay}: negll/meas {losses[0]:.3f} -> "
           f"{losses[-1]:.3f}")
        info("  fitted per-group RMS sigma:  " + "  ".join(
            f"{g}: q={q_grp[g]:.2e}" + (f" r={r_grp[g]:.2e}" if g in r_grp else "")
            for g in q_grp))
        if args.filter == "koopman":
            warn("--filter koopman uses only the fitted R; the fitted (state-space) Q does "
                 "not transfer to the lifted system (process noise stays --koopman-q)")
        record["fit_noise"] = {
            "seconds": t_fit,
            "negll_first": float(losses[0]),
            "negll_last": float(losses[-1]),
            "q_var_diag": np.exp(log_q).tolist(),
            "r_var_diag": np.exp(log_r).tolist(),
            "r_sigma_groups": r_grp,
            **stats,
        }

    # ---- filter ----------------------------------------------------------
    if args.filter == "koopman":
        # data-driven filter: EDMDc fitted on the (noisy) training split,
        # then the exact linear KF on its lifted system
        model, _, fit_warm = common.fit_koopman_from_args(
            args, torch.Generator(device), X_d[:n_tr], U_d[:n_tr])
        ok(f"EDMDc model fitted on the training split for the lifted KF ({args.n_rbfs} RBFs, "
           f"warm {fit_warm:.3f} s)")
        U_k = U_d[:N - 1]
        run_filter = lambda: estimation.koopman_kalman_filter(  # noqa: E731
            model, R, U_k, Y, q=args.koopman_q)
    else:
        run_filter = {
            "ekf": lambda: estimation.ekf(step, h, Q, R, m0, P0, TAU_trans, Y),
            "ukf": lambda: estimation.ukf(step, h, Q, R, m0, P0, TAU_trans, Y),
            "pf": lambda: estimation.particle_filter(
                step, h, Q, R, m0, P0, TAU_trans, Y, n_particles=args.pf_particles,
                seed=args.seed),
            "mhe": lambda: estimation.mhe(
                step, h, Q, R, m0, P0, TAU_trans, Y, window=args.mhe_window,
                iters=args.mhe_iters, init_iters=20 * args.mhe_iters,
                meas_loss=args.mhe_meas_loss),
        }[args.filter]
    res, cold, warm = _timed(run_filter)
    timing = f"warm {warm:.4f} s (cold incl. graph capture {cold:.2f} s)"
    if args.filter == "mhe":
        diag_text = (f"{args.mhe_meas_loss} MHE, window {args.mhe_window} "
                     f"x {args.mhe_iters} iters")
        ok(f"MHE ({args.mhe_meas_loss}) over {N} steps: {timing}; final window cost "
           f"{float(res.losses[-1]):.2f}")
        record.update({"mhe_final_cost": float(res.losses[-1]),
                       "meas_loss": args.mhe_meas_loss,
                       "filter_warm_s": warm, "filter_cold_s": cold})
    elif args.filter == "pf":
        ess_mean = float(torch.mean(res.ess))
        diag_text = f"mean ESS {ess_mean:.0f}/{args.pf_particles} particles"
        ok(f"PF ({args.pf_particles} particles) over {N} steps: {timing}; loglik "
           f"{float(res.loglik):.1f}, {diag_text}")
        record.update({"loglik": float(res.loglik), "ess_mean": ess_mean,
                       "n_particles": args.pf_particles,
                       "filter_warm_s": warm, "filter_cold_s": cold})
    else:
        nis_mean = float(torch.mean(res.nis))
        diag_text = f"mean NIS {nis_mean:.2f} (chi^2 expectation {Y.shape[1]})"
        ok(f"{args.filter.upper()} over {N} steps: {timing}; loglik {float(res.loglik):.1f}, "
           f"{diag_text}")
        record.update({"loglik": float(res.loglik), "nis_mean": nis_mean,
                       "filter_warm_s": warm, "filter_cold_s": cold})

    sm = None
    if args.smooth:
        sm, cold_s, warm_s = _timed(
            lambda: estimation.rts_smooth(step, Q, TAU_trans, res))
        ok(f"RTS smoother backward pass: warm {warm_s:.4f} s (cold {cold_s:.2f} s)")
        record.update({"smooth_warm_s": warm_s, "smooth_cold_s": cold_s})

    X_filt = _host(res.means)
    X_best = _host(sm.means) if sm is not None else X_filt

    # ---- accuracy vs truth (synthetic only) ------------------------------
    if X_true is not None:
        rows = {"raw sensor": _group_rmse(X, X_true),
                args.filter.upper(): _group_rmse(X_filt, X_true)}
        if sm is not None:
            rows["RTS smoothed"] = _group_rmse(X_best, X_true)
        _print_rmse_table(rows)
        record["rmse_vs_truth"] = rows
        if hasattr(res, "covs"):
            ne = estimation.nees(res, f32(X_true))
            record["nees_mean"] = float(torch.mean(ne[10:]))
            info(f"mean NEES (post-transient): {record['nees_mean']:.2f} (chi^2 expectation 12)")
    else:
        info("No ground truth available (real CSV) — NIS/loglik are the consistency "
             "diagnostics.")

    # ---- downstream value: Koopman refit on filtered states --------------
    if args.refit_koopman:
        from bluerov2_dynamics_tpu_torch.models import koopman

        X_te_true, U_te = f32(X_true[n_tr:]), U_d[n_tr:]
        generator = torch.Generator(device)
        rows_k = {}
        for label, Xtr in (("raw", X[:n_tr]), ("filtered", X_best[:n_tr])):
            generator.manual_seed(args.seed)
            model = koopman.fit(generator, f32(Xtr), U_d[:n_tr], n_rbfs=args.n_rbfs,
                                gamma=args.gamma, ridge=args.ridge,
                                position_invariant=args.koopman_position_invariant)
            rows_k[label] = {H: float(koopman.multistep_rmse(
                model, X_te_true, U_te, H=H, method=common.koopman_method(args)))
                for H in common.HORIZONS}
        print("\n[metrics] Koopman endpoint RMSE on NOISE-FREE truth "
              "(train on raw vs filtered states):")
        print("  Train states          |" + "|".join(
            f" {('H=%d' % H):>10} " for H in common.HORIZONS))
        for label, vals in rows_k.items():
            print(f"  {label:<21} |" + "|".join(f" {vals[H]:>10.6f} " for H in common.HORIZONS))
        record["koopman_refit"] = {k: {str(H): v for H, v in d.items()}
                                   for k, d in rows_k.items()}

    # ---- artifacts --------------------------------------------------------
    if not args.no_media:
        try:
            # non-default filters get their own filename so a ukf/pf/
            # koopman run never clobbers the EKF figures
            fig_name = ("estimate_channels"
                        + ("_pose" if pose_only else "")
                        + (f"_{args.filter}" if args.filter != "ekf" else "")
                        + ".png")
            _save_figure(Path(args.media_dir) / fig_name, dt, X, X_filt,
                         X_best if sm is not None else None, X_true, diag_text)
        except ImportError:
            warn("matplotlib unavailable — skipping the estimation figure")

    if args.out_csv:
        _write_csv(args.out_csv, ["t"] + csv_loader.EULER12_COLS + csv_loader.THRUSTER_COLS,
                   np.column_stack([t_stamps, X_best, U]),
                   f"{'smoothed' if sm is not None else 'filtered'} thruster-contract CSV")
    if args.json_out:
        _write(args.json_out, json.dumps(json_sanitize(record), indent=2), "JSON run record")
    return record


if __name__ == "__main__":
    main()

"""Flagship comparison (T6): Koopman, Fossen, DI and PINc, fully timed.

Counterpart of ``bluerov2_dynamics_tpu/apps/tank_full_comparison.py``: four
models on the thruster-input tank recording, with timed fits, endpoint
RMSE at H = 1/10/100 and timed open-loop rollouts.  The Fossen row runs K2
fused on the card (Euler, or RK4 with ``--integrator rk4``).  The PINc
weights load from ``--pinc-ckpt``: a reference ``.pt`` state dict, or a
flax-layout msgpack file whose ``.json`` sidecar carries the training
configuration; without a checkpoint PINc is trained and saved there, with
its sidecar.  ``--fossen-fit`` fits the Fossen coefficients to the
training split (:mod:`..models.sysid`, with the app's integrator) and adds
a "Fossen (fitted)" row, on the same kernel, and its open-loop rollout.
Unless ``--no-media``, the rollouts are drawn into ``<media-dir>`` as the
JAX app draws them (:func:`save_media`).

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.tank_full_comparison
--synthetic --recording --steps 45823 --pinc-ckpt models/pinc_best.msgpack
--pinc-psi-ssa --no-media``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.eval.timing import time_fn, time_fn_cold_warm
from bluerov2_dynamics_tpu_torch.models import di, fossen, koopman, pinc
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from bluerov2_dynamics_tpu_torch.utils.log import info, ok

# the reference's training configuration; a sidecar that differs marks a tuned checkpoint
REFERENCE_TRAINING = (("normalize", False), ("position_invariant", False), ("lr_schedule", "const"))


def parser():
    ap = common.base_parser(__doc__)
    ap.add_argument("--pinc-epochs", type=int, default=200)
    ap.add_argument("--pinc-ckpt", type=str, default="models/pinc_best.msgpack")
    ap.add_argument("--pinc-hidden", type=int, nargs="+", default=[64, 64, 64, 64])
    ap.add_argument("--pinc-normalize", action="store_true",
                    help="standardize PINc inputs (improvement over the reference)")
    ap.add_argument("--pinc-position-invariant", action="store_true",
                    help="mask x,y,z from the PINc MLP input (improvement)")
    ap.add_argument("--pinc-lr-schedule", choices=["const", "cosine"], default="const",
                    help="PINc learning-rate schedule (cosine = improvement)")
    ap.add_argument("--pinc-ckpt-unsafe-unpickle", action="store_true",
                    help="allow FULL unpickling of a --pinc-ckpt .pt file that is not a "
                         "weights-only state_dict (runs arbitrary code from the file; "
                         "trusted files only)")
    ap.add_argument("--pinc-dp", type=int, default=1, metavar="N",
                    help="data-parallel PINc training over the N ranks of the process "
                         "group the app runs in, one device a rank (1 = single-device)")
    ap.add_argument("--pinc-psi-ssa", action="store_true",
                    help="also report PINc RMSE with the yaw error wrapped to the smallest "
                         "signed angle (the reference scores raw unwrapped psi)")
    ap.add_argument("--integrator", choices=["euler", "rk4"], default="euler")
    ap.add_argument("--media-prefix", type=str, default="",
                    help="filename prefix for saved media (lets the RK4 workload keep "
                         "separate artifacts)")
    ap.add_argument("--json-out", type=str, default=None,
                    help="write metrics + timings as JSON to this path")
    common.add_sysid_args(ap)
    return ap


def dp_mesh(n: int, device: torch.device):
    """The mesh of ``--pinc-dp n``: ``None`` for one device, else the
    ``n`` ranks of the process group the app was started in."""
    if n <= 1:
        return None
    import torch.distributed as dist

    from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh

    if dist.is_initialized():
        have = dist.get_world_size()
    else:
        have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have < n:
        raise SystemExit(f"--pinc-dp {n}: only {have} devices available")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise SystemExit(f"--pinc-dp {n}: start the app on {n} ranks of one process group, "
                         f"one device a rank (e.g. torchrun --nproc-per-node {n})")
    info(f"PINc DP training over {n} devices")
    return pmesh.make_mesh(axis_names=("data",), device_type=device.type)


def pinc_from_args(args, X_tr, U_tr, dt: float, cfg, lag, device):
    """The PINc net the args select: imported from a ``.pt`` state dict,
    loaded from a msgpack checkpoint (its sidecar overriding
    ``--pinc-position-invariant``), or trained and saved with its sidecar.
    Returns ``(net, seconds)``; loading counts 0 s."""
    hidden = tuple(args.pinc_hidden)
    ckpt = Path(args.pinc_ckpt)
    sidecar = ckpt.with_suffix(ckpt.suffix + ".json")
    if ckpt.exists() and ckpt.suffix == ".pt":
        info(f"Importing torch PINc checkpoint: {ckpt}")
        return pinc.load_torch_checkpoint(
            ckpt, hidden, allow_full_unpickle=args.pinc_ckpt_unsafe_unpickle, device=device), 0.0
    if ckpt.exists():
        info(f"Loading PINc checkpoint: {ckpt}")
        pi_flag = args.pinc_position_invariant
        if sidecar.exists():
            # params trained with masked inputs are wrong through an
            # unmasked net and the other way round: the sidecar wins
            meta = json.loads(sidecar.read_text())
            hidden = tuple(meta.get("hidden", hidden))
            pi_flag = bool(meta.get("position_invariant", pi_flag))
            if pi_flag != args.pinc_position_invariant:
                info(f"Checkpoint sidecar overrides --pinc-position-invariant"
                     f" -> {pi_flag} (trained that way)")
            tuned = [k for k, ref_val in REFERENCE_TRAINING if meta.get(k, ref_val) != ref_val]
            if tuned:
                print("[notice] Loaded a TUNED (non-reference) PINc "
                      f"checkpoint: {', '.join(tuned)} differ from the "
                      "reference training configuration. Delete the "
                      "checkpoint (or point --pinc-ckpt elsewhere) to "
                      "retrain reference-faithfully.")
        tree = load_pytree(ckpt, {"params": {"params": None}, "norm_mu": None, "norm_sigma": None})
        return convert.pinc_params_from_numpy(
            tree["params"], tree["norm_mu"], tree["norm_sigma"], hidden,
            position_invariant=pi_flag, device=device), 0.0
    if ckpt.suffix == ".pt":
        # a missing .pt path must not fall into the train branch, which
        # would save msgpack bytes under the .pt name
        raise SystemExit(
            f"--pinc-ckpt {ckpt}: .pt paths are for importing an existing "
            "torch checkpoint (e.g. the reference's models/pinc_best.pt), "
            "but the file does not exist. To train and checkpoint, pass a "
            ".msgpack path.")

    info("Training PINc (no checkpoint found).")
    data = pinc.make_dataset(X_tr, U_tr, dt, cfg, lag)
    tc = pinc.TrainConfig(epochs=args.pinc_epochs, normalize=args.pinc_normalize,
                          position_invariant=args.pinc_position_invariant,
                          lr_schedule=args.pinc_lr_schedule)
    mesh = dp_mesh(args.pinc_dp, device)
    generator = torch.Generator(device).manual_seed(args.seed + 1)
    (net, _hist), t_pinc = time_fn(
        lambda: pinc.train(generator, data, tc, hidden, mesh=mesh), warmup=0)
    if mesh is None or mesh.get_rank() == 0:
        save_pytree(ckpt, {"params": convert.pinc_params_to_numpy(net),
                           "norm_mu": np.asarray(net.norm_mu, np.float64),
                           "norm_sigma": np.asarray(net.norm_sigma, np.float64)})
        sidecar.write_text(json.dumps({
            "hidden": list(hidden),
            "normalize": args.pinc_normalize,
            "position_invariant": args.pinc_position_invariant,
            "lr_schedule": args.pinc_lr_schedule,
            "epochs": args.pinc_epochs,
        }))
        ok(f"Saved PINc checkpoint -> {ckpt} (+ config sidecar)")
    return net, t_pinc


def save_media(args, trajs, dt, fit_res) -> None:
    """The JAX app's figures: the rollouts' GIF, the first 10 s in 2-D
    (PINc left out), and with ``--fossen-fit`` the fitted coefficient
    scales.  On a generated pseudo recording the scales' truth is the
    generator's draws, here :func:`..data.synthetic.recording_coefficient_draws`
    (a torch stream, so not the JAX package's threefry draws)."""
    from bluerov2_dynamics_tpu_torch.viz import animate_topdown, plot_topdown_with_depth

    prefix = f"{args.media_dir}/{args.media_prefix}"
    animate_topdown(
        trajs, dt=dt,
        save_path=f"{prefix}tank_true_vs_4models.gif",
        title="Recorded data: True vs. Koopman / Fossen / DI / PINc",
    )
    plot_topdown_with_depth(
        {k: v for k, v in trajs.items() if "PINc" not in k},
        dt=dt, seconds=10.0,
        save_path=f"{prefix}tank_true_vs_4models_2D.png",
    )
    if fit_res is not None:
        from bluerov2_dynamics_tpu_torch.models.sysid import COEFF_NAMES
        from bluerov2_dynamics_tpu_torch.viz import plot_coefficient_scales

        true_scales = None
        if (args.synthetic or args.csv is None) and getattr(args, "recording", False):
            from bluerov2_dynamics_tpu_torch.data.synthetic import recording_coefficient_draws

            true_scales = recording_coefficient_draws(args.seed, args.coeff_jitter)
        plot_coefficient_scales(
            np.exp(fit_res.log_scales.double().cpu().numpy()),
            COEFF_NAMES, true_scales=true_scales,
            stderr=(None if fit_res.stderr is None
                    else fit_res.stderr["s"].double().cpu().numpy()),
            save_path=f"{prefix}fossen_fit_scales.png",
        )


def main(argv=None, device=None):
    """The T6 workload; ``device=None`` means ``cuda``.  Returns the RMSE
    and metric timing tables (``rmse``, ``warm_s``, ``cold_s``: name -> H
    -> value), the fits' seconds (``fit_s``), the rollouts' ``(cold,
    warm)`` seconds, the open-loop trajectories (host arrays), the data's
    seconds, the fitted models (``model``, ``gains``, ``net``), the train
    and test splits (host float64), and the Fossen fit (``sysid``, None
    without ``--fossen-fit``) with its seconds (``sysid_s``)."""
    args = parser().parse_args(argv)
    device = resolve_device(device)

    t0 = time.perf_counter()
    ds = common.load_or_generate(args, csv_loader.load_thruster_dataset, device)
    data_s = time.perf_counter() - t0
    train, test = csv_loader.train_test_split(ds, args.train_split)
    info(f"Train: {len(train.X)} | Test: {len(test.X)}")
    dt = float(ds.dt)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    X_tr, U_tr, X_te, U_te = f32(train.X), f32(train.U), f32(test.X), f32(test.U)

    # ---------------- fits (timed) ----------------
    model, t_koop_cold, t_koop = common.fit_koopman_from_args(
        args, torch.Generator(device), X_tr, U_tr, loader=csv_loader.load_thruster_dataset)
    common.summarize_fit("Koopman", t_koop_cold, t_koop)
    gains, t_di_cold, t_di = time_fn_cold_warm(
        lambda: di.estimate_gains(X_tr, U_tr, dt, ridge=1e-3))
    common.summarize_fit("Double Integrator", t_di_cold, t_di)

    cfg, lag = thruster_config(device=device), lag_params(dt, device=device)
    net, t_pinc = pinc_from_args(args, X_tr, U_tr, dt, cfg, lag, device)
    ok(f"PINc ready. (fit/load time = {t_pinc:.3f} s)")
    print("\n[timings] Train/Fit, warm (s): "
          f"Koopman {t_koop:.4f} | Fossen 0.0000 | DI {t_di:.4f} | PINc {t_pinc:.4f}")
    print("[timings] Train/Fit, cold (s): "
          f"Koopman {t_koop_cold:.4f} | Fossen 0.0000 | DI {t_di_cold:.4f}")

    # ---------------- metrics ----------------
    U4_te = pinc.wrench4_from_thrusters(cfg, lag, U_te)
    di_step = (di.make_step_euler12(gains, dt) if args.integrator == "euler"
               else di.make_step_euler12_rk4(gains, dt))
    k_method = common.koopman_method(args)
    evaluators = {
        "Koopman": lambda H: koopman.multistep_rmse(model, X_te, U_te, H, method=k_method),
        "Fossen (BlueROV2)": fossen_evaluator(dt, test.X, test.U, method=args.integrator,
                                              device=device),
        "Double Integrator": lambda H: metrics.endpoint_rmse(di_step, X_te, U_te, H),
        "PINc (ResDNN)": lambda H: pinc.endpoint_rmse(net, X_te, U4_te, dt, H),
    }
    if args.pinc_psi_ssa:
        evaluators["PINc (ssa psi)"] = lambda H: pinc.endpoint_rmse(
            net, X_te, U4_te, dt, H, psi_error="ssa")
    fit_res, sysid_s = common.fit_fossen_from_args(args, X_tr, U_tr, dt, kind="thruster",
                                                   method=args.integrator)
    if fit_res is not None:
        evaluators["Fossen (fitted)"] = fossen_evaluator(
            dt, test.X, test.U, method=args.integrator, p=fit_res.params, cfg=fit_res.cfg,
            device=device)
    rmses, times, cold_times = common.timed_metric_table(evaluators)
    fit_s = {"koopman": (t_koop_cold, t_koop), "di": (t_di_cold, t_di), "pinc": t_pinc}
    if args.json_out:
        payload = {
            "dataset": {"steps": args.steps, "dt": dt, "recording": bool(args.recording),
                        "coeff_jitter": args.coeff_jitter},
            "fit_seconds_warm": {"koopman": t_koop, "di": t_di, "pinc": t_pinc},
            "rmse": rmses,
            "metric_seconds_warm": times,
            "backend": device.type,
        }
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(common.json_sanitize(payload), indent=1, allow_nan=False))
        ok(f"Wrote JSON run record -> {args.json_out}")

    # ---------------- open-loop rollouts (timed) ----------------
    start, horizon = common.open_loop_window(test.X, args.open_loop_steps)
    x0 = X_te[start]
    U_seq = U_te[start:start + horizon]
    timer = common.make_timer()
    p = fossen_params(device=device)
    di_variant = "euler12" if args.integrator == "euler" else "euler12_rk4"
    runs = {
        "Koopman": (lambda: koopman.simulate(model, x0, U_seq)),
        "Fossen (BlueROV2)": (lambda: fossen.simulate_thruster(p, cfg, lag, x0, U_seq, dt,
                                                               method=args.integrator)),
        "Double Integrator": (lambda: di.simulate(gains, x0, U_seq, dt, variant=di_variant)),
        "PINc (ResDNN)": (lambda: pinc.simulate(net, x0, U4_te[start:start + horizon], dt)),
    }
    if fit_res is not None:
        runs["Fossen (fitted)"] = lambda: fossen.simulate_thruster(
            fit_res.params, fit_res.cfg, lag, x0, U_seq, dt, method=args.integrator)
    preds, rollout_times = {}, {}
    for name, run in runs.items():
        pred, cold, warm = timer(run)
        preds[name], rollout_times[name] = pred.double().cpu().numpy(), (cold, warm)
    common.print_rollout_timings(rollout_times)
    trajs = {"TRUE (Recorded)": test.X[start:start + horizon + 1],
             "KOOPMAN": preds["Koopman"], "FOSSEN (BlueROV2)": preds["Fossen (BlueROV2)"],
             "DOUBLE INTEGRATOR": preds["Double Integrator"],
             "PINc (ResDNN)": preds["PINc (ResDNN)"]}
    if fit_res is not None:
        trajs["FOSSEN (fitted)"] = preds["Fossen (fitted)"]
    if not args.no_media:
        save_media(args, trajs, dt, fit_res)
    ok("done")
    return {"rmse": rmses, "warm_s": times, "cold_s": cold_times, "fit_s": fit_s,
            "rollout_s": rollout_times, "trajs": trajs, "data_s": data_s, "model": model,
            "gains": gains, "net": net, "train": train, "test": test, "sysid": fit_res,
            "sysid_s": sysid_s}


if __name__ == "__main__":
    main()

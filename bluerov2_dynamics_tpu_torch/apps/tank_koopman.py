"""Tank workload (T2): Koopman identification on a tank recording.

Counterpart of ``bluerov2_dynamics_tpu/apps/tank_koopman.py``: load the
50 Hz tank CSV (thruster contract) or generate the pseudo recording
(``--synthetic --recording``), fit Koopman with 500 RBFs / gamma=3 /
ridge=0.1, report endpoint RMSE at H = 1/10/100, and roll the model open
loop over 500 steps.  ``--physics-baseline`` also evaluates the Fossen
model through the same evaluator (on the card: K2 fused, one launch a
horizon), and ``--fossen-fit`` fits the Fossen coefficients to the
training split (:mod:`..models.sysid`) and scores the fitted model through
it too ("Fossen (fitted)").  The open-loop rollout is animated into
``<media-dir>/tank_true_vs_koopman.gif`` unless ``--no-media``.

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.tank_koopman
--synthetic --recording --steps 45823 --physics-baseline --no-media``.
"""

from __future__ import annotations

import time

import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.models import fossen, koopman
from bluerov2_dynamics_tpu_torch.models.params import (
    fossen_params,
    lag_params,
    thruster_config,
)
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import make_endpoint_sq_cuda
from bluerov2_dynamics_tpu_torch.utils.log import info, ok


def fossen_evaluator(dt, X_test, U_test, method="euler", p=None, cfg=None,
                     device=None):
    """``fn(H) -> endpoint RMSE`` of the full thruster-input physics model.

    ``X_test (N, 12)`` and ``U_test (N, 8)`` move to ``device`` as float32
    (``None`` means ``cuda``).  On CUDA the fused sliding-window kernel
    (K2, one launch that returns the summed squared error) runs; on the
    CPU the batched step loop does.  ``p``/``cfg`` default to the
    nominal Table A1 set; fitted values go through the same path, since
    the kernel takes its coefficients at launch.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    U_test = torch.as_tensor(U_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    cfg = cfg.to(device) if cfg is not None else thruster_config(device=device)
    lag = lag_params(dt, device=device)
    step = fossen.make_thruster_step(p, cfg, lag, dt, method=method)
    return common.endpoint_evaluator_with_kernel(
        X_test, U_test,
        build_kernel=lambda H: make_endpoint_sq_cuda(p, cfg, lag, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse_carry(
            step,
            lambda x: torch.zeros((*x.shape[:-1], 8, 3), dtype=x.dtype, device=x.device),
            X_test, U_test, H,
        ),
    )


def main(argv=None, device=None):
    """The T2 workload; ``device=None`` means ``cuda``.  Returns the
    open-loop ``pred`` and ``true`` arrays, the RMSE and timing tables
    (``rmse``, ``warm_s``, ``cold_s``: name -> H -> value), the fit's
    ``(cold, warm)`` seconds, the data's seconds, the model, the train
    and test splits (host float64), and the Fossen fit (``sysid``, None
    without ``--fossen-fit``) with its seconds (``sysid_s``)."""
    ap = common.base_parser(__doc__)
    ap.add_argument("--physics-baseline", action="store_true")
    ap.add_argument("--decoder", action="store_true",
                    help="learn a linear decoder x ~ W z instead of the "
                         "first-n-coordinates readout")
    ap.add_argument("--save-model", type=str, default=None,
                    help="save the fitted Koopman model (centers, gamma, "
                         "A, B, optional decoder/weights) as .npz")
    ap.add_argument("--load-model", type=str, default=None,
                    help="load a saved model (this package's or the JAX "
                         "package's .npz) instead of fitting")
    common.add_sysid_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device)

    t0 = time.perf_counter()
    ds = common.load_or_generate(args, csv_loader.load_thruster_dataset, device)
    data_s = time.perf_counter() - t0
    train, test = csv_loader.train_test_split(ds, args.train_split)
    info(f"Train: {len(train.X)} | Test: {len(test.X)}")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    X_tr, U_tr = f32(train.X), f32(train.U)

    if args.load_model:
        info(f"Loading Koopman model: {args.load_model}")
        model = koopman.load_model(args.load_model, device=device)
        t_fit_cold = t_fit = 0.0
    else:
        model, t_fit_cold, t_fit = common.fit_koopman_from_args(
            args, torch.Generator(device), X_tr, U_tr, loader=csv_loader.load_thruster_dataset)
    common.summarize_fit("Koopman", t_fit_cold, t_fit)
    if args.decoder:
        model = koopman.fit_decoder(model, X_tr)
        info("Learned linear decoder fitted (x ~ W z readout).")
    if args.save_model:
        koopman.save_model(args.save_model, model)
        ok(f"Saved Koopman model -> {args.save_model}")

    X_test, U_test = f32(test.X), f32(test.U)
    k_method = common.koopman_method(args)
    evaluators = {
        "Koopman": lambda H: koopman.multistep_rmse(model, X_test, U_test, H, method=k_method),
    }
    if args.physics_baseline:
        evaluators["Fossen (BlueROV2)"] = fossen_evaluator(float(ds.dt), test.X, test.U,
                                                           device=device)
    fit_res, sysid_s = common.fit_fossen_from_args(args, X_tr, U_tr, float(ds.dt),
                                                   kind="thruster")
    if fit_res is not None:
        evaluators["Fossen (fitted)"] = fossen_evaluator(
            float(ds.dt), test.X, test.U, p=fit_res.params, cfg=fit_res.cfg, device=device)
    rmses, warm, cold = common.timed_metric_table(evaluators)

    start, horizon = common.open_loop_window(test.X, args.open_loop_steps)
    pred = koopman.simulate(model, X_test[start], U_test[start:start + horizon])
    pred = pred.double().cpu().numpy()
    true = test.X[start:start + horizon + 1]
    if not args.no_media:
        from bluerov2_dynamics_tpu_torch.viz import animate_topdown

        animate_topdown(
            {"TRUE (Recorded)": true, "KOOPMAN": pred},
            dt=float(ds.dt),
            save_path=f"{args.media_dir}/tank_true_vs_koopman.gif",
            title="Tank recording: True vs. Koopman (top view)",
        )
    ok("done")
    return {"pred": pred, "true": true,
            "rmse": rmses, "warm_s": warm, "cold_s": cold, "fit_s": (t_fit_cold, t_fit),
            "data_s": data_s, "model": model, "train": train, "test": test,
            "sysid": fit_res, "sysid_s": sysid_s}


if __name__ == "__main__":
    main()

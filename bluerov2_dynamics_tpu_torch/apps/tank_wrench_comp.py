"""Wrench workload, Euler state (T3): Koopman vs Fossen vs DI on 6-D
wrench inputs.

Counterpart of ``bluerov2_dynamics_tpu/apps/tank_wrench_comp.py``: a
12-state recording whose 8 thruster commands become a 6-D body wrench
through the BlueROV2-heavy effectiveness matrix (``data/wrench.py``), or a
CSV in the wrench contract, drives a Koopman(12, 6) model, the
wrench-input Fossen model (on the card: K4 fused, one launch a horizon)
and a learned double integrator, scored by one endpoint evaluator, then
rolled open loop.  ``--fossen-fit`` fits the wrench model's coefficients
to the training split (:mod:`..models.sysid`) and adds a "Fossen
(fitted)" row on the same kernel.  The rollouts are animated into
``<media-dir>/tank_wrench_comparison.gif`` unless ``--no-media``.

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp
--synthetic --recording --steps 45823 --no-media``.
"""

from __future__ import annotations

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.data.wrench import thrusters_to_wrench
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.eval.timing import time_fn_cold_warm
from bluerov2_dynamics_tpu_torch.models import di, fossen, koopman
from bluerov2_dynamics_tpu_torch.models.params import fossen_params
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import make_endpoint_sq_cuda_wrench
from bluerov2_dynamics_tpu_torch.ops.integrators import rollout
from bluerov2_dynamics_tpu_torch.utils.log import info


def wrench_dataset(X, U):
    """``(X (N, 12), U (N, 8))`` thruster recording -> ``(X, W (N, 6))``
    with the normalised body wrench of the recorded vehicle (host, numpy)."""
    return np.asarray(X), thrusters_to_wrench(np.asarray(U))


def fossen_wrench_evaluator(dt, X_test, TAU_test, method="euler", p=None, device=None):
    """``fn(H) -> endpoint RMSE`` of the wrench-input euler12 Fossen model.

    ``X_test (N, 12)`` and ``TAU_test (N, 6)`` move to ``device`` as
    float32 (``None`` means ``cuda``).  On CUDA the fused sliding-window
    kernel (K4, one launch) runs; on the CPU the batched step loop does.
    ``p`` defaults to the nominal Table A1 set.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    TAU_test = torch.as_tensor(TAU_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    step = fossen.make_wrench_step(p, dt, method=method, state="euler12")
    return common.endpoint_evaluator_with_kernel(
        X_test, TAU_test,
        build_kernel=lambda H: make_endpoint_sq_cuda_wrench(p, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse(step, X_test, TAU_test, H),
    )


def main(argv=None, device=None):
    """The T3 workload; ``device=None`` means ``cuda``.  Returns the
    open-loop predictions ``koopman``, ``fossen``, ``di`` and ``true``
    (host arrays), the RMSE and timing tables (``rmse``, ``warm_s``,
    ``cold_s``), the fits' ``(cold, warm)`` seconds, the models, the train
    and test splits (host float64), and the Fossen fit (``sysid``, None
    without ``--fossen-fit``) with its seconds (``sysid_s``)."""
    ap = common.base_parser(__doc__)
    common.add_sysid_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device)
    if args.synthetic or args.csv is None:
        ds = common.synthetic_wrench_dataset(args, device)
    else:
        ds = common.load_or_generate(args, csv_loader.load_wrench_dataset, device)
    train, test = csv_loader.train_test_split(ds, args.train_split)
    info(f"Train: {len(train.X)} | Test: {len(test.X)}")
    dt = float(ds.dt)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    X_tr, U_tr, X_te, U_te = f32(train.X), f32(train.U), f32(test.X), f32(test.U)

    model, t_koop_cold, t_koop = common.fit_koopman_from_args(
        args, torch.Generator(device), X_tr, U_tr, loader=csv_loader.load_wrench_dataset)
    common.summarize_fit("Koopman", t_koop_cold, t_koop)
    gains, t_di_cold, t_di = time_fn_cold_warm(lambda: di.estimate_gains(X_tr, U_tr, dt))
    common.summarize_fit("Double Integrator", t_di_cold, t_di)

    fossen_step = fossen.make_wrench_step(fossen_params(device=device), dt, method="euler",
                                          state="euler12")
    di_step = di.make_step_euler12(gains, dt)
    k_method = common.koopman_method(args)
    evaluators = {
        "Koopman": lambda H: koopman.multistep_rmse(model, X_te, U_te, H, method=k_method),
        "Fossen (wrench)": fossen_wrench_evaluator(dt, test.X, test.U, device=device),
        "Double Integrator": lambda H: metrics.endpoint_rmse(di_step, X_te, U_te, H),
    }
    fit_res, sysid_s = common.fit_fossen_from_args(args, X_tr, U_tr, dt, kind="wrench",
                                                   state="euler12")
    if fit_res is not None:
        evaluators["Fossen (fitted)"] = fossen_wrench_evaluator(dt, test.X, test.U, p=fit_res.params,
                                                    device=device)
    rmses, warm, cold = common.timed_metric_table(evaluators)

    start, horizon = common.open_loop_window(test.X, args.open_loop_steps)
    x0, U_seq = X_te[start], U_te[start:start + horizon]
    host = lambda t: t.double().cpu().numpy()  # noqa: E731
    with torch.no_grad():
        predK = koopman.simulate(model, x0, U_seq)
        _, predF = rollout(fossen_step, x0, U_seq, include_initial=True)
        _, predD = rollout(di_step, x0, U_seq, include_initial=True)
    predK, predF, predD = host(predK), host(predF), host(predD)
    true = test.X[start:start + horizon + 1]
    if not args.no_media:
        from bluerov2_dynamics_tpu_torch.viz import animate_topdown

        animate_topdown(
            {
                "TRUE (Recorded)": true,
                "KOOPMAN": predK,
                "FOSSEN (wrench)": predF,
                "DOUBLE INTEGRATOR": predD,
            },
            dt=dt,
            save_path=f"{args.media_dir}/tank_wrench_comparison.gif",
            title="Wrench inputs: True vs. Koopman / Fossen / DI",
            ncols=2,
        )
    return {"koopman": predK, "fossen": predF, "di": predD,
            "true": true, "rmse": rmses, "warm_s": warm,
            "cold_s": cold, "fit_s": {"koopman": (t_koop_cold, t_koop), "di": (t_di_cold, t_di)},
            "model": model, "gains": gains, "train": train, "test": test, "sysid": fit_res,
            "sysid_s": sysid_s}


if __name__ == "__main__":
    main()

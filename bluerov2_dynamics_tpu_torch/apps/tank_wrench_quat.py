"""Quaternion workload (T4): Koopman vs quat-Fossen vs quat-DI.

Counterpart of ``bluerov2_dynamics_tpu/apps/tank_wrench_quat.py``: a
12-state recording becomes a 13-state quaternion recording (quaternions
formed in float64 on the host) under the 6-D body wrench of
``data/wrench.py``, or a quaternion CSV loads (legacy Euler CSVs
converted).  Koopman(13, 6) is scored with its quaternion renormalised
before the error, the quaternion wrench-input Fossen model renormalises
after every step (on the card: K5 fused, one launch a horizon), and the
quaternion double integrator renormalises too; then each rolls open loop.
``--fossen-fit`` fits the quat13 wrench model's coefficients to the
training split (:mod:`..models.sysid`) and adds a "Fossen (fitted)" row on
the same kernel.  The rollouts are animated into
``<media-dir>/tank_wrench_quat_comparison.gif`` unless ``--no-media``.

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat
--synthetic --recording --steps 45823 --no-media``.
"""

from __future__ import annotations

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.data.csv_loader import euler_to_quat_np
from bluerov2_dynamics_tpu_torch.data.wrench import thrusters_to_wrench
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.eval.timing import time_fn_cold_warm
from bluerov2_dynamics_tpu_torch.models import di, fossen, koopman
from bluerov2_dynamics_tpu_torch.models.params import fossen_params
from bluerov2_dynamics_tpu_torch.ops.cuda_quat import make_endpoint_sq_cuda_quat
from bluerov2_dynamics_tpu_torch.ops.integrators import rollout
from bluerov2_dynamics_tpu_torch.utils.log import info


def quat_dataset(X, U):
    """``(X (N, 12), U (N, 8))`` thruster recording -> ``(X13 (N, 13),
    W (N, 6))``: Euler angles to unit quaternions and thruster commands to
    the body wrench, in float64 on the host."""
    X = np.asarray(X, np.float64)
    q = euler_to_quat_np(X[:, 3], X[:, 4], X[:, 5])
    X13 = np.concatenate([X[:, 0:3], q, X[:, 6:12]], axis=1)
    return X13, thrusters_to_wrench(np.asarray(U, np.float64))


def fossen_quat_evaluator(dt, X_test, TAU_test, method="euler", p=None, device=None):
    """``fn(H) -> endpoint RMSE`` of the quat13 wrench-input Fossen model,
    renormalised after every step.

    ``X_test (N, 13)`` and ``TAU_test (N, 6)`` move to ``device`` as
    float32 (``None`` means ``cuda``).  On CUDA the fused sliding-window
    kernel (K5, one launch) runs; on the CPU the batched step loop does.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    TAU_test = torch.as_tensor(TAU_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    step = fossen.make_wrench_step(p, dt, method=method, state="quat13")
    return common.endpoint_evaluator_with_kernel(
        X_test, TAU_test,
        build_kernel=lambda H: make_endpoint_sq_cuda_quat(p, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse(step, X_test, TAU_test, H),
    )


def main(argv=None, device=None):
    """The T4 workload; ``device=None`` means ``cuda``.  Returns what
    :func:`bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp.main`
    returns, for the quat13 models."""
    ap = common.base_parser(__doc__)
    common.add_sysid_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device)
    if args.synthetic or args.csv is None:
        ds = common.synthetic_quat_dataset(args, device)
    else:
        ds = common.load_or_generate(args, csv_loader.load_quat_dataset, device)
    train, test = csv_loader.train_test_split(ds, args.train_split)
    info(f"Train: {len(train.X)} | Test: {len(test.X)}")
    dt = float(ds.dt)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    X_tr, U_tr, X_te, U_te = f32(train.X), f32(train.U), f32(test.X), f32(test.U)

    model, t_koop_cold, t_koop = common.fit_koopman_from_args(
        args, torch.Generator(device), X_tr, U_tr, loader=csv_loader.load_quat_dataset)
    common.summarize_fit("Koopman (quat)", t_koop_cold, t_koop)
    gains, t_di_cold, t_di = time_fn_cold_warm(lambda: di.estimate_gains(X_tr, U_tr, dt))
    common.summarize_fit("Double Integrator (quat)", t_di_cold, t_di)

    fossen_step = fossen.make_wrench_step(fossen_params(device=device), dt, method="euler",
                                          state="quat13")
    di_step = di.make_step_quat13(gains, dt)
    k_method = common.koopman_method(args)
    evaluators = {
        "Koopman (quat)": lambda H: koopman.multistep_rmse(
            model, X_te, U_te, H, post_decode=fossen.renormalize_quat13, method=k_method),
        "Fossen (quat)": fossen_quat_evaluator(dt, test.X, test.U, device=device),
        "DI (quat)": lambda H: metrics.endpoint_rmse(di_step, X_te, U_te, H),
    }
    fit_res, sysid_s = common.fit_fossen_from_args(args, X_tr, U_tr, dt, kind="wrench",
                                                   state="quat13")
    if fit_res is not None:
        evaluators["Fossen (fitted)"] = fossen_quat_evaluator(dt, test.X, test.U, p=fit_res.params,
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
                "KOOPMAN (quat)": predK,
                "FOSSEN (quat)": predF,
                "DI (quat)": predD,
            },
            dt=dt,
            save_path=f"{args.media_dir}/tank_wrench_quat_comparison.gif",
            title="Quaternion state: True vs. Koopman / Fossen / DI",
            ncols=2,
        )
    return {"koopman": predK, "fossen": predF, "di": predD,
            "true": true, "rmse": rmses, "warm_s": warm,
            "cold_s": cold, "fit_s": {"koopman": (t_koop_cold, t_koop), "di": (t_di_cold, t_di)},
            "model": model, "gains": gains, "train": train, "test": test, "sysid": fit_res,
            "sysid_s": sysid_s}


if __name__ == "__main__":
    main()

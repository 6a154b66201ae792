"""Simulation workload (T1): generate data from the physics model, fit
Koopman EDMDc, report multi-step RMSE, roll the model open loop.

Counterpart of ``bluerov2_dynamics_tpu/apps/sim_koopman.py``: AR(1)-driven
Euler simulation with sensor noise, 80/20 causal split (the test range
starts at split-1), Koopman with 200 RBFs / gamma=1 / ridge=1e-3, H =
1/10/100 endpoint RMSE, a 200-step open-loop rollout, animated into
``<media-dir>/sim_true_vs_koopman.gif`` unless ``--no-media``.

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.sim_koopman
--media-dir DIR``.
"""

from __future__ import annotations

import time

import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.data.synthetic import generate_sim_dataset
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval.timing import sync
from bluerov2_dynamics_tpu_torch.models import koopman
from bluerov2_dynamics_tpu_torch.utils.log import info, ok


def main(argv=None, device=None):
    """The T1 workload; ``device=None`` means ``cuda``.  Returns the
    open-loop ``pred`` and ``true`` arrays, ``rmse`` (H -> value: the
    one-step RMSE at H=1), the data's and the fit's seconds, the model and
    the train and test splits (host float64)."""
    ap = common.base_parser(__doc__)
    ap.set_defaults(n_rbfs=200, gamma=1.0, ridge=1e-3, steps=48_000, dt=0.05)
    ap.add_argument("--demo-steps", type=int, default=200)
    args = ap.parse_args(argv)
    if getattr(args, "extra_csv", None):
        raise SystemExit(
            "--extra-csv applies to the tank workloads; the simulation "
            "workload (T1) generates its own dataset and would silently "
            "ignore the extra recordings.")
    device = resolve_device(device)

    t0 = time.perf_counter()
    sim = generate_sim_dataset(args.seed, n_steps=args.steps, dt=args.dt, device=device)
    ds = csv_loader.Dataset(X=sim.X.double().cpu().numpy(), U=sim.U.double().cpu().numpy(),
                            t=torch.arange(args.steps).numpy() * args.dt, dt=args.dt)
    data_s = time.perf_counter() - t0
    ok(f"Generated {args.steps} steps in {data_s:.3f} s")
    train, test = csv_loader.train_test_split(ds, args.train_split, causal_overlap=True)
    info(f"Train: {len(train.X)} | Test: {len(test.X)}")

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    t0 = time.perf_counter()
    model = sync(koopman.fit(torch.Generator(device).manual_seed(args.seed),
                             f32(train.X), f32(train.U),
                             n_rbfs=args.n_rbfs, gamma=args.gamma, ridge=args.ridge))
    fit_s = time.perf_counter() - t0
    ok(f"Model fitted! ({fit_s:.3f} s)")

    X_test, U_test = f32(test.X), f32(test.U)
    rmses = {1: float(koopman.evaluate(model, X_test, U_test))}
    print(f"One-step RMSE on test set: {rmses[1]:.4f}")
    for H in (10, 100):
        rmses[H] = float(koopman.multistep_rmse(model, X_test, U_test, H,
                                                method=common.koopman_method(args)))
        print(f"{H}-step RMSE on test set: {rmses[H]:.4f}")

    horizon = min(args.demo_steps, len(test.X) - 1)
    pred = koopman.simulate(model, X_test[0], U_test[:horizon]).double().cpu().numpy()
    true = test.X[:horizon + 1]
    if not args.no_media:
        from bluerov2_dynamics_tpu_torch.viz import animate_topdown

        animate_topdown(
            {"TRUE (BlueROV2)": true, "KOOPMAN PREDICTION": pred},
            dt=args.dt,
            save_path=f"{args.media_dir}/sim_true_vs_koopman.gif",
            title="Simulation: True vs. Koopman (top view)",
            speed=2.0,
        )
    return {"pred": pred, "true": true, "rmse": rmses,
            "data_s": data_s, "fit_s": fit_s, "model": model, "train": train, "test": test}


if __name__ == "__main__":
    main()

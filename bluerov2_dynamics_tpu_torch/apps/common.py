"""Pieces shared by the port's apps: arguments, datasets (the T3/T4
recordings too), the Koopman and differentiable Fossen fits from the
command line, timed metric and rollout tables, strict-JSON run records and
the evaluator policy.

Counterpart of ``bluerov2_dynamics_tpu/apps/common.py``.  Every app takes
``device`` (``None`` means ``cuda``); datasets stay numpy float64 on the
host, as in the JAX package, and move to the device as float32 where a
model runs.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.data import csv_loader
from bluerov2_dynamics_tpu_torch.eval.timing import time_fn_cold_warm
from bluerov2_dynamics_tpu_torch.utils.log import info, ok
from bluerov2_dynamics_tpu_torch.utils.profiling import span

HORIZONS = (1, 10, 100)


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--csv", type=str, default=None,
                    help="dataset CSV file, or a directory to search for the "
                         "newest --csv-name under; omit with --synthetic")
    ap.add_argument("--csv-name", type=str, default="koopman_dataset_50Hz.csv",
                    help="file name searched for when --csv is a directory")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a simulated dataset instead of loading a CSV")
    ap.add_argument("--recording", action="store_true",
                    help="with --synthetic: generate the pseudo tank "
                         "recording (perturbed generator coefficients, "
                         "yaw-winding commands, sensor noise) instead of "
                         "the nominal-parameter sim dataset")
    ap.add_argument("--coeff-jitter", type=float, default=0.10,
                    help="generator coefficient perturbation for --recording")
    ap.add_argument("--noise-scale", type=float, default=1.0,
                    help="multiply the synthetic generator's per-channel "
                         "sensor-noise sigmas (1.0 = mocap-scale defaults); "
                         "the noise draw is unchanged, so truth and commands "
                         "stay the same")
    ap.add_argument("--steps", type=int, default=20_000,
                    help="synthetic dataset length")
    ap.add_argument("--dt", type=float, default=0.02,
                    help="synthetic dataset sample period")
    ap.add_argument("--train-split", type=float, default=0.8)
    ap.add_argument("--open-loop-steps", type=int, default=500)
    ap.add_argument("--media-dir", type=str, default="media")
    ap.add_argument("--no-media", action="store_true", help="skip animations/figures")
    ap.add_argument("--n-rbfs", type=int, default=500)
    ap.add_argument("--gamma", type=float, default=3.0)
    ap.add_argument("--ridge", type=float, default=1e-1)
    ap.add_argument("--koopman-position-invariant", action="store_true",
                    help="mask x,y,z out of the RBF distances (the dynamics "
                         "are translation-invariant)")
    ap.add_argument("--koopman-conv", action="store_true",
                    help="score Koopman multistep metrics by the batched "
                         "control-convolution endpoint "
                         "(koopman.multistep_rmse(method='conv')); default is "
                         "the step recurrence")
    ap.add_argument("--sweep", action="store_true",
                    help="fit every (gamma, ridge) combination (one lift and "
                         "Gram a gamma, one batched solve) and keep the best "
                         "on a validation tail (koopman.fit_sweep)")
    ap.add_argument("--sweep-gammas", type=float, nargs="+",
                    default=[0.5, 1.0, 3.0, 10.0])
    ap.add_argument("--sweep-ridges", type=float, nargs="+",
                    default=[1e-3, 1e-2, 1e-1])
    ap.add_argument("--streaming-chunk", type=int, default=None,
                    help="fit the Koopman model through the streaming "
                         "sufficient-statistics accumulator in chunks of "
                         "this many rows (koopman.fit_streaming; equals the "
                         "batch fit at --forgetting 1)")
    ap.add_argument("--forgetting", type=float, default=1.0,
                    help="exponential forgetting factor for "
                         "--streaming-chunk (RLS memory ~1/(1-lam) pairs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extra-csv", nargs="*", default=[],
                    help="additional recording CSVs used as extra training "
                         "trajectories, fitted jointly without cross-file "
                         "transitions (koopman.fit_multi); metrics stay on "
                         "the main dataset's test split")
    return ap


def add_sysid_args(ap: argparse.ArgumentParser) -> None:
    """CLI options for the differentiable Fossen coefficient fit
    (:mod:`bluerov2_dynamics_tpu_torch.models.sysid`)."""
    g = ap.add_argument_group("differentiable Fossen fit (extension)")
    g.add_argument("--fossen-fit", action="store_true",
                   help="fit the 23 Table A1 coefficients to the training "
                        "split by gradient descent through the rollout and "
                        "report a 'Fossen (fitted)' metric row (the nominal "
                        "Fossen row is unchanged)")
    g.add_argument("--fossen-fit-steps", type=int, default=300,
                   help="Adam iterations (full-batch; on the card one CUDA "
                        "graph of an iteration, replayed)")
    g.add_argument("--fossen-fit-horizon", type=int, default=10,
                   help="multi-step prediction-loss window length")
    g.add_argument("--fossen-fit-lr", type=float, default=0.02,
                   help="Adam learning rate in log-scale space")
    g.add_argument("--fossen-fit-gains", action="store_true",
                   help="additionally fit 8 per-thruster gain factors "
                        "(actuator asymmetry; thruster-input workloads only)")
    g.add_argument("--fossen-fit-current", action="store_true",
                   help="additionally estimate a constant ambient NED "
                        "current (3 additive parameters, m/s)")
    g.add_argument("--fossen-fit-stderr", action="store_true",
                   help="report Gauss-Newton/Laplace standard errors per "
                        "coefficient (identifiability diagnostic; "
                        "torch.func.hessian through the rollout)")
    g.add_argument("--fossen-fit-delay", type=int, choices=(0, 1), default=None,
                   help="which command drives the step from X[k]: 0 = U[k] "
                        "(evaluator/reference convention, right for real "
                        "recordings), 1 = U[k+1] (the generated datasets' "
                        "discrete pairing; see sysid.fit_thruster). Default: "
                        "1 for generated data, 0 for CSV data")


def fit_fossen_from_args(args, X_tr, U_tr, dt, kind: str = "thruster",
                         method: str = "euler", state: str = "euler12"):
    """Run the differentiable coefficient fit when ``--fossen-fit`` is set.

    ``X_tr``/``U_tr`` are tensors on the device the fit runs on.  Returns
    ``(result, seconds)``: a
    :class:`~bluerov2_dynamics_tpu_torch.models.sysid.SysidResult` (``None``
    when the flag is off, with 0 s) and the fit's host seconds, graph
    capture and standard errors included, and prints the fit summary.
    ``kind`` selects the input contract: ``"thruster"`` (u1..u8 datasets)
    or ``"wrench"`` (Fx..Mz datasets, with ``state`` euler12/quat13).
    """
    if not getattr(args, "fossen_fit", False):
        return None, 0.0
    from bluerov2_dynamics_tpu_torch.eval.timing import time_fn
    from bluerov2_dynamics_tpu_torch.models import sysid

    delay = args.fossen_fit_delay
    if delay is None:
        # generated datasets record each command next to the state it
        # produced (see sysid.fit_thruster); real CSVs pair U[k] with the
        # state it is about to act on.  The condition matches the
        # data-selection branch (load_or_generate): --synthetic wins over
        # --csv, so synthetic data keeps delay 1 even with both set.
        delay = 1 if (args.synthetic or args.csv is None) else 0
    kwargs = dict(horizon=args.fossen_fit_horizon, steps=args.fossen_fit_steps,
                  lr=args.fossen_fit_lr, method=method, input_delay=delay,
                  fit_current=args.fossen_fit_current,
                  compute_stderr=getattr(args, "fossen_fit_stderr", False))
    if kind == "thruster":
        fit = lambda: sysid.fit_thruster(  # noqa: E731
            X_tr, U_tr, dt, fit_gains=args.fossen_fit_gains, **kwargs)
    elif kind == "wrench":
        fit = lambda: sysid.fit_wrench(X_tr, U_tr, dt, state=state, **kwargs)  # noqa: E731
    else:
        raise ValueError(f"unknown sysid kind {kind!r}")
    res, t_fit = time_fn(fit, warmup=0)
    losses = res.losses.double().cpu().numpy()
    ok(f"Fossen coefficients fitted ({args.fossen_fit_steps} Adam steps, "
       f"horizon {args.fossen_fit_horizon}, input delay {delay}): loss "
       f"{losses[0]:.3e} -> {losses[-1]:.3e} in {t_fit:.2f} s (a CUDA graph's capture included)")
    if res.current is not None:
        c = [f"{v:+.4f}" for v in res.current.tolist()]
        ok(f"Estimated ambient NED current [m/s]: [{', '.join(c)}]")
    if res.stderr is not None:
        scales = np.exp(res.log_scales.double().cpu().numpy())
        se = res.stderr["s"].double().cpu().numpy()
        print("[i] Coefficient scales +- Laplace stderr (log-space; inf = "
              "unidentifiable on this recording; optimistic in absolute "
              "terms — see sysid._laplace_stderr):")
        cells = [
            f"{n} {s:.3f}±{'inf' if not np.isfinite(e) else format(e, '.3f')}"
            for n, s, e in zip(sysid.COEFF_NAMES, scales, se)
        ]
        for row_start in range(0, len(cells), 6):
            print("      " + "  ".join(f"{c:<16s}" for c in cells[row_start:row_start + 6]))
    return res, t_fit


def koopman_method(args) -> str:
    """Koopman multistep propagation method selected by --koopman-conv."""
    return "conv" if getattr(args, "koopman_conv", False) else "scan"


def _generate_sim(args, device=None):
    """The synthetic dataset the CLI args select (on ``device``)."""
    from bluerov2_dynamics_tpu_torch.data.synthetic import (
        generate_sim_dataset,
        generate_tank_recording,
    )

    if getattr(args, "recording", False):
        info(f"Generating pseudo tank recording: {args.steps} steps @ "
             f"dt={args.dt} (coeff jitter +-{args.coeff_jitter:.0%})")
        return generate_tank_recording(
            args.seed, n_steps=args.steps, dt=args.dt, jitter=args.coeff_jitter,
            noise_scale=getattr(args, "noise_scale", 1.0), device=device,
        )
    info(f"Generating synthetic dataset: {args.steps} steps @ dt={args.dt}")
    return generate_sim_dataset(
        args.seed, n_steps=args.steps, dt=args.dt,
        noise_scale=getattr(args, "noise_scale", 1.0), device=device,
    )


def _generated(args, device):
    """The synthetic dataset the args select, generated on ``device``, and
    its noise-free states (host, float64)."""
    t0 = time.perf_counter()
    sim = _generate_sim(args, device)
    host = lambda a: a.double().cpu().numpy()  # noqa: E731
    ok(f"Generated {args.steps} steps in {time.perf_counter() - t0:.3f} s")
    return (csv_loader.Dataset(X=host(sim.X), U=host(sim.U), t=np.arange(args.steps) * args.dt,
                               dt=args.dt), host(sim.X_true))


def load_or_generate(args, loader: Callable = csv_loader.load_thruster_dataset, device=None):
    """Load the CSV named by --csv (or found under it), or generate the
    synthetic dataset on ``device``; returns a host float64 ``Dataset``."""
    if args.synthetic or args.csv is None:
        return _generated(args, device)[0]
    from pathlib import Path

    csv_path = Path(args.csv)
    if csv_path.is_dir():
        csv_path = csv_loader.find_latest_csv(
            csv_path, getattr(args, "csv_name", "koopman_dataset_50Hz.csv"))
    return loader(csv_path)


def load_or_generate_with_truth(args, loader: Callable = csv_loader.load_thruster_dataset,
                               device=None):
    """:func:`load_or_generate` plus what only the estimation app needs:
    the generator's noise-free states (``None`` for CSV data) and the
    dataset's input delay.  Generated datasets record each command next to
    the state it produced (the transition ``X[k] -> X[k+1]`` is driven by
    ``U[k+1]``, delay 1; see ``sysid.fit_thruster``); real CSVs pair
    ``U[k]`` with the state it is about to act on (delay 0).  Returns
    ``(Dataset, X_true or None, input_delay)``, host float64."""
    if args.synthetic or args.csv is None:
        return (*_generated(args, device), 1)
    return load_or_generate(args, loader, device), None, 0


def synthetic_wrench_dataset(args, device=None) -> csv_loader.Dataset:
    """T3's synthetic recording: the thruster recording the args select,
    its commands mapped to the body wrench (host, float64)."""
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp import wrench_dataset

    ds = load_or_generate(args, csv_loader.load_thruster_dataset, device)
    X, W = wrench_dataset(ds.X, ds.U)
    return csv_loader.Dataset(X=X, U=W, t=ds.t, dt=ds.dt)


def synthetic_quat_dataset(args, device=None) -> csv_loader.Dataset:
    """T4's synthetic recording: the thruster recording the args select as
    quat13 states under the body wrench (host, float64)."""
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import quat_dataset

    ds = load_or_generate(args, csv_loader.load_thruster_dataset, device)
    X13, W = quat_dataset(ds.X, ds.U)
    return csv_loader.Dataset(X=X13, U=W, t=ds.t, dt=ds.dt)


def fit_koopman_from_args(args, generator, X_tr, U_tr, loader: Callable = None):
    """Fit the Koopman model the CLI args select, timed cold and warm.

    One fit at (--gamma, --ridge) by default; ``--sweep`` fits every
    (gamma, ridge) combination and keeps the best by endpoint H=10 RMSE
    on the last 20% of the training split; ``--extra-csv`` fits the
    training split and every extra recording jointly
    (``koopman.fit_multi``); ``--streaming-chunk`` fits through the
    streaming accumulator.  ``generator`` seeds k-means++ (a
    ``torch.Generator`` on the data's device); it is re-seeded from
    ``args.seed`` before each timed fit, so the warm refit repeats the
    cold one.  Returns ``(model, cold_seconds, warm_seconds)``.
    """
    from bluerov2_dynamics_tpu_torch.models import koopman

    def seeded(fn):
        def run():
            generator.manual_seed(args.seed)
            return fn()
        return run

    pi = getattr(args, "koopman_position_invariant", False)
    chunk = getattr(args, "streaming_chunk", None)
    lam = float(getattr(args, "forgetting", 1.0))
    if lam != 1.0 and chunk is None:
        raise SystemExit(
            "--forgetting only applies to the streaming fit; add "
            "--streaming-chunk N (otherwise the batch fit would silently "
            "ignore it).")
    extra = getattr(args, "extra_csv", None) or []
    if extra:
        if getattr(args, "sweep", False):
            raise SystemExit(
                "--extra-csv fits via koopman.fit_multi, which does not "
                "support --sweep; drop one of the flags.")
        if chunk:
            raise SystemExit(
                "--extra-csv fits via koopman.fit_multi, which does not "
                "support --streaming-chunk (a stream has one contiguous "
                "recording); drop one of the flags.")
        loader = loader or csv_loader.load_thruster_dataset
        extras = [loader(p) for p in extra]
        X_list = [X_tr] + [torch.as_tensor(e.X, dtype=X_tr.dtype, device=X_tr.device)
                           for e in extras]
        U_list = [U_tr] + [torch.as_tensor(e.U, dtype=U_tr.dtype, device=U_tr.device)
                           for e in extras]
        info(f"Multi-trajectory fit over {len(X_list)} recordings "
             f"({sum(len(x) for x in X_list)} rows total)")
        return time_fn_cold_warm(seeded(lambda: koopman.fit_multi(
            generator, X_list, U_list, n_rbfs=args.n_rbfs, gamma=args.gamma,
            ridge=args.ridge, position_invariant=pi)))
    if chunk is not None:
        if chunk < 1:
            raise SystemExit(f"--streaming-chunk must be >= 1, got {chunk}")
        if getattr(args, "sweep", False):
            raise SystemExit(
                "--streaming-chunk fits via koopman.fit_streaming, which "
                "does not support --sweep; drop one of the flags.")
        if not (0.0 < lam <= 1.0):
            raise SystemExit(f"--forgetting must be in (0, 1], got {lam}")
        n_chunks = -(-max(len(X_tr), 1) // chunk)
        mem = "full history" if lam == 1.0 else f"~{1.0 / (1.0 - lam):.0f} pairs"
        info(f"Streaming fit: {n_chunks} chunks of {chunk} rows, "
             f"forgetting {lam:g} (RLS memory {mem})")
        return time_fn_cold_warm(seeded(lambda: koopman.fit_streaming(
            generator, X_tr, U_tr, n_rbfs=args.n_rbfs, gamma=args.gamma,
            ridge=args.ridge, chunk=chunk, position_invariant=pi, forgetting=lam)))
    if not getattr(args, "sweep", False):
        return time_fn_cold_warm(seeded(lambda: koopman.fit(
            generator, X_tr, U_tr, n_rbfs=args.n_rbfs, gamma=args.gamma,
            ridge=args.ridge, position_invariant=pi)))

    n_val = max(int(0.2 * len(X_tr)), max(HORIZONS) + 1)
    if len(X_tr) - n_val < max(args.n_rbfs, 2):
        raise SystemExit(
            f"--sweep needs a training split larger than the validation "
            f"tail plus the dictionary ({len(X_tr)} rows, n_val={n_val}, "
            f"n_rbfs={args.n_rbfs}); use more data or fewer RBFs.")
    X_fit, U_fit = X_tr[:-n_val], U_tr[:-n_val]
    X_val, U_val = X_tr[-n_val:], U_tr[-n_val:]

    def fit():
        models, combos = koopman.fit_sweep(
            generator, X_fit, U_fit, n_rbfs=args.n_rbfs,
            gammas=tuple(args.sweep_gammas), ridges=tuple(args.sweep_ridges),
            position_invariant=pi)
        return koopman.select_best(models, combos, X_val, U_val, H=10,
                                   method=koopman_method(args))

    (model, combo, rmses), cold, warm = time_fn_cold_warm(seeded(fit))
    vals = rmses.double().cpu().numpy()
    n_bad = int(np.isnan(vals).sum())
    bad = f", {n_bad} combo(s) NaN (ill-conditioned, skipped)" if n_bad else ""
    info(f"Sweep over {len(args.sweep_gammas)}x{len(args.sweep_ridges)} "
         f"(gamma, ridge) combos -> best gamma={float(combo[0]):g} "
         f"ridge={float(combo[1]):g} (val H=10 RMSE "
         f"{np.nanmin(vals):.6f}, worst finite {np.nanmax(vals):.6f}{bad})")
    return model, cold, warm


def make_timer():
    """``timer(fn, *args) -> (result, cold_s, warm_s)`` for app tables: one
    cold and one warm call, each ended by a synchronise of the card."""

    def timer(fn, *args):
        return time_fn_cold_warm(fn, *args, iters=1)

    return timer


def timed_metric_table(evaluators: Dict[str, Callable[[int], float]],
                       horizons: Sequence[int] = HORIZONS):
    """Evaluate every model at every horizon with timings and print the
    tables in the reference's format.  ``evaluators``: name -> fn(H)
    returning the endpoint RMSE.  Returns ``(rmse[name][H],
    warm_seconds[name][H], cold_seconds[name][H])``."""
    timer = make_timer()
    rmses: Dict[str, Dict[int, float]] = {}
    times: Dict[str, Dict[int, float]] = {}
    cold_times: Dict[str, Dict[int, float]] = {}
    for name, fn in evaluators.items():
        rmses[name], times[name], cold_times[name] = {}, {}, {}
        for H in horizons:
            val, cold_s, warm_s = timer(fn, H)
            rmses[name][H] = float(val)
            times[name][H] = warm_s
            cold_times[name][H] = cold_s

    names = list(evaluators)
    print("\n[metrics] Endpoint RMSE (identical evaluator):")
    header = "  Model                 |" + "|".join(
        f" {('%d-step RMSE' % H):>13} " for H in horizons)
    print(header)
    print("  " + "-" * (len(header) - 2))
    for n in names:
        print(f"  {n:<21} |" + "|".join(f" {rmses[n][H]:>13.6f} " for H in horizons))
    print("\n[timings] Metric evaluation, warm (s, one synchronised call):")
    for n in names:
        print(f"  {n:<21} |" + "|".join(f" {times[n][H]:>13.4f} " for H in horizons))
    print("[timings] Metric evaluation, cold (s, first call):")
    for n in names:
        print(f"  {n:<21} |" + "|".join(f" {cold_times[n][H]:>13.4f} " for H in horizons))
    return rmses, times, cold_times


def json_sanitize(obj):
    """``obj`` with every non-finite float replaced by ``None``, so that
    ``json.dumps(..., allow_nan=False)`` writes strict JSON."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def print_rollout_timings(timings: Dict[str, tuple]):
    """``timings``: name -> (cold_seconds, warm_seconds)."""
    print("\n[timings] Open-loop rollout time:")
    print("  Model                 |    warm [s] | cold [s]")
    print("  ----------------------|------------:|---------:")
    for n, (cold, warm) in timings.items():
        print(f"  {n:<21} | {warm:11.6f} | {cold:8.6f}")


def open_loop_window(X_test: np.ndarray, horizon: int):
    """Start index and horizon of the demo rollout."""
    horizon = min(horizon, len(X_test) - 1)
    start = int(0.4 * (len(X_test) - horizon))
    return start, horizon


def summarize_fit(name: str, cold_seconds: float, warm_seconds: float = None):
    """Report fit timing: ``cold`` is the first fit, ``warm`` a refit."""
    if warm_seconds is None:
        ok(f"{name} fitted. (fit time = {cold_seconds:.3f} s)")
    else:
        ok(f"{name} fitted. (warm fit = {warm_seconds:.3f} s, "
           f"cold = {cold_seconds:.3f} s)")


def fused_rmse(sq_fn: Callable, X, U, H: int):
    """Endpoint RMSE from a fused window evaluator (``make_endpoint_sq_cuda*``:
    ``(X, U) ->`` the squared endpoint error summed over the ``N - H``
    starts): ``sqrt(sq / ((N - H) n))``.  The span ``brov2.wrapper.rmse``
    holds the divide and sqrt alone; the launch has its own span."""
    N, n = X.shape
    sq = sq_fn(X, U)
    with span("brov2.wrapper.rmse"):
        return torch.sqrt(sq / ((N - H) * n))


def endpoint_evaluator_with_kernel(X_test, U_test, build_kernel: Callable,
                                   scan_eval: Callable) -> Callable:
    """Physics-baseline evaluator policy: ``fn(H) -> endpoint RMSE``.

    The policy follows the device of ``X_test``: on CUDA the fused window
    evaluator built by ``build_kernel(H)`` runs, one kernel launch and a
    sqrt (:func:`fused_rmse`; evaluators cached per H, so warm timings stay
    warm); on the CPU ``scan_eval(H)`` runs.  ``H >= len(X_test)`` returns
    NaN.  Each call is the span ``brov2.evaluate`` in a profiler's trace.
    """
    use_kernel = X_test.is_cuda
    cache: Dict[int, Callable] = {}

    def run(H: int):
        with span("brov2.evaluate"):
            if X_test.shape[0] - H <= 0:
                return torch.tensor(float("nan"), dtype=X_test.dtype, device=X_test.device)
            if use_kernel:
                if H not in cache:
                    cache[H] = build_kernel(H)
                return fused_rmse(cache[H], X_test, U_test, H)
            return scan_eval(H)

    return run

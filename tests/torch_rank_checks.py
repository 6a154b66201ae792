"""Inputs and rank-side work of ``tests/test_torch_parallel.py``, and the
port tests' one intra-op thread.

A module of its own, importing torch, numpy and the port only, because
``parallel.launch.run_ranks`` starts each rank in a fresh interpreter that
imports the function it runs by its module: the ranks then never import
JAX.  The inputs are made with numpy from a seed, so that the ranks and
the JAX side of the test build the same arrays.

Importing it sets torch to one intra-op thread.  The suite runs several
pytest workers on as many cores; a worker's default pool of a thread a
core then contends with the others', and MKL's LAPACK wakes its threads
for every small call: a 3 x 3 Cholesky of the port's Riccati loop takes
15-26 ms in a loaded worker against 5 us on one thread.  Every worker
imports every test file before it runs a test, and
``tests/test_torch_parallel.py`` and ``tests/test_torch_pinc.py`` import
this module.
"""

from __future__ import annotations

import os

import numpy as np
import torch

torch.set_num_threads(1)

DT = 0.02
WORLD = 4
H_WINDOW = 10                      # __graft_entry__.dryrun_multichip stages 5 and 6
N_WINDOW = 32 * WORLD + H_WINDOW
H_FOSSEN = 5
KOOP_N, KOOP_K, KOOP_H, KOOP_GAMMA, KOOP_RIDGE = 96, 11, 7, 0.8, 1e-3
KOOP_LAMS = (1.0, 0.97)
# PINc training (tests/test_torch_pinc.py): the JAX package's initial
# parameters and draws reach the ranks in an .npz named by this variable
PINC_INPUTS = "TORCH_RANK_CHECKS_PINC_INPUTS"
PINC_HIDDEN = (16, 16)
PINC_TRAIN = dict(epochs=3, batch=64, rollout_steps=5, rollout_windows=8, normalize=True,
                  position_invariant=True, lr_schedule="cosine")
# the Fossen identification (tests/test_sysid.py::test_fit_mesh_invariance):
# 404 rows, horizon 3, 6 Adam steps, input delay 1
SYSID_N = 404
SYSID_FIT = dict(horizon=3, steps=6, lr=0.05, input_delay=1)
# the filter banks (tests/test_parallel.py::test_sharded_*_bank_*): a
# 3-state linear system seen in 2 channels, banks of 16 and 11
# trajectories (divisible by 4 and not), 30 EKF steps, 20 PF steps of 64
# particles
BANK_SIZES = (16, 11)
BANK_T, BANK_T_PF, BANK_PARTICLES, BANK_SEED = 30, 20, 64, 4
# MPPI with its sample axis over the ranks (tests/test_parallel.py::
# test_sharded_mppi_matches_single_device): a 3-state linear plant under
# tanh inputs, 15 plant steps of an 8-step plan, 64 samples (16 a rank)
# and 60 (15 a rank)
MPPI_SAMPLES = (64, 60)
MPPI_KW = dict(sim_steps=15, horizon=8, sigma=0.2, temperature=0.05, init_rounds=5,
               replan_rounds=2, u_dim=2, seed=3)


def inputs(seed: int = 0) -> dict:
    """Every array the 4-rank checks use, float32 for the window
    evaluators and float64 for the step loops."""
    rng = np.random.default_rng(seed)
    d = {}
    d["X12"] = (rng.normal(size=(N_WINDOW, 12)) * 0.1).astype(np.float32)
    d["U8"] = np.clip(rng.normal(size=(N_WINDOW, 8)) * 0.4, -1, 1).astype(np.float32)
    d["TAU6"] = (rng.normal(size=(N_WINDOW, 6)) * 4.0).astype(np.float32)
    X13 = rng.normal(size=(N_WINDOW, 13)) * 0.1
    X13[:, 3] += 1.0                                   # near-identity quaternions
    d["X13"] = X13.astype(np.float32)
    d["A"] = np.eye(3) + 0.01 * rng.normal(size=(3, 3))
    d["B"] = 0.1 * rng.normal(size=(2, 3))
    d["X_lin"], d["U_lin"] = rng.normal(size=(120, 3)), rng.normal(size=(120, 2))
    d["X_div"], d["U_div"] = rng.normal(size=(104, 3)), rng.normal(size=(104, 2))
    d["x0"] = rng.normal(size=(64, 12)) * 0.2
    d["TAU_roll"] = rng.normal(size=(25, 6))
    d["X_fossen"] = rng.normal(size=(12 * WORLD + H_FOSSEN, 12)) * 0.2
    d["TAU_fossen"] = rng.normal(size=(12 * WORLD + H_FOSSEN, 6))
    # the Koopman checks: 4 states, 2 inputs, 11 centers (lift d = 15, which
    # splits 8/7 over a 2-rank model axis), a stable operator
    rng = np.random.default_rng(seed + 1)
    d["koop_X"] = np.cumsum(rng.normal(size=(KOOP_N, 4)) * 0.2, axis=0)
    d["koop_U"] = rng.normal(size=(KOOP_N, 2))
    d["koop_C"] = d["koop_X"][rng.choice(KOOP_N, KOOP_K, replace=False)]
    n_lift = 4 + KOOP_K
    d["koop_A"] = 0.9 * np.eye(n_lift) + 0.02 * rng.normal(size=(n_lift, n_lift))
    d["koop_B"] = 0.1 * rng.normal(size=(n_lift, 2))
    d["koop_X_prior"], d["koop_U_prior"] = rng.normal(size=(9, 4)), rng.normal(size=(9, 2))
    # the sysid fits: a slowly drifting euler12 record, its quat13 form
    # and smooth thruster commands and wrenches
    rng = np.random.default_rng(seed + 2)
    d["sysid_X"] = np.cumsum(rng.normal(size=(SYSID_N, 12)) * 0.01, axis=0)
    d["sysid_U"] = np.clip(np.cumsum(rng.normal(size=(SYSID_N, 8)) * 0.05, axis=0), -1, 1)
    d["sysid_TAU"] = np.cumsum(rng.normal(size=(SYSID_N, 6)) * 0.2, axis=0)
    X13 = np.concatenate([d["sysid_X"][:, :3], np.ones((SYSID_N, 1)),
                          0.05 * d["sysid_X"][:, 3:6], d["sysid_X"][:, 6:]], axis=1)
    d["sysid_X13"] = X13
    rng = np.random.default_rng(seed + 3)
    B = max(BANK_SIZES)
    d["bank_U"] = rng.normal(size=(B, BANK_T - 1, 2))
    d["bank_Y"] = rng.normal(size=(B, BANK_T, 2))
    d["bank_m0"] = rng.normal(size=(B, 3))
    rng = np.random.default_rng(seed + 4)
    d["mppi_A"] = np.eye(3) * 0.9 + 0.02 * rng.normal(size=(3, 3))
    d["mppi_B"] = 0.2 * rng.normal(size=(3, 2))
    d["mppi_x0"] = rng.normal(size=3)
    return d


def sysid_fits(d, mesh=None) -> dict:
    """The thruster fit (gains, current, standard errors) and the quat13
    wrench fit on ``d``'s sysid record, with ``mesh`` or on one device;
    host arrays keyed ``"<fit>.<field>"``."""
    from bluerov2_dynamics_tpu_torch.models import sysid

    out = {}
    fits = {
        "thruster": lambda: sysid.fit_thruster(
            d["sysid_X"], d["sysid_U"], DT, fit_gains=True, fit_current=True,
            compute_stderr=True, mesh=mesh, device="cpu", **SYSID_FIT),
        "quat13": lambda: sysid.fit_wrench(
            d["sysid_X13"], d["sysid_TAU"], DT, state="quat13", mesh=mesh, device="cpu",
            **SYSID_FIT),
    }
    for name, fit in fits.items():
        res = fit()
        for field in ("losses", "log_scales", "log_gains", "current"):
            v = getattr(res, field)
            if v is not None:
                out[f"{name}.{field}"] = v.numpy()
        for k, v in (res.stderr or {}).items():
            out[f"{name}.stderr.{k}"] = v.numpy()
    return out


def koopman_model(d):
    from bluerov2_dynamics_tpu_torch.models import koopman
    return koopman.KoopmanModel(d["koop_C"], torch.tensor(KOOP_GAMMA, dtype=torch.float64),
                                d["koop_A"], d["koop_B"])


def koopman_stats0(d, lam):
    """Streaming statistics that already hold a prior segment."""
    from bluerov2_dynamics_tpu_torch.models import koopman
    s = koopman.streaming_init(d["koop_C"], KOOP_GAMMA, 2, dtype=torch.float64, device="cpu")
    return koopman.streaming_update(s, d["koop_X_prior"], d["koop_U_prior"], lam)


def koopman_checks(d, mesh, mesh2) -> dict:
    """The sharded Koopman functions' values on this rank: the multistep
    RMSE on the 2 x 2 mesh (starts over 'data', A's rows over 'model'),
    the fit and the streaming statistics over 4 ranks of 'data'."""
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    out = {}
    model = koopman_model(d)
    X, U = d["koop_X"], d["koop_U"]
    for method in ("scan", "conv"):
        for H in (0, 1, KOOP_H):
            out[f"koop_ms_{method}_H{H}"] = float(sharded.sharded_koopman_multistep_rmse(
                mesh2, model, X, U, H, method=method))
        out[f"koop_ms_{method}_nan"] = float(sharded.sharded_koopman_multistep_rmse(
            mesh2, model, X, U, KOOP_N, method=method))
    mask = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    for pi in (False, True):
        init = d["koop_C"] * mask if pi else d["koop_C"]
        m = sharded.sharded_koopman_fit(mesh, None, X, U, KOOP_K, KOOP_GAMMA, KOOP_RIDGE, 0,
                                        position_invariant=pi, fit_decoder=not pi, init=init)
        out[f"koop_fit_pi{int(pi)}"] = {k: None if v is None else v.numpy()
                                        for k, v in m._asdict().items()}
    for lam in KOOP_LAMS:
        s = sharded.sharded_streaming_stats(mesh, koopman_stats0(d, lam), X, U, 10, lam)
        out[f"koop_stream_{lam}"] = {k: None if v is None else v.numpy()
                                     for k, v in s._asdict().items()}
    out["koop_stream_indivisible"] = _error(lambda: sharded.sharded_streaming_stats(
        mesh, koopman_stats0(d, 1.0), X[:-1], U[:-1], 10))
    return out


def nested(flat: dict, prefix: str) -> dict:
    """``{"Dense_0": {"kernel": ...}, ...}`` from the ``prefix.Dense_0.kernel``
    keys of a flat dict."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix + "."):
            _, a, b = k.split(".")
            out.setdefault(a, {})[b] = v
    return out


def pinc_train(d: dict, mesh=None, **overrides):
    """The port's ``train_from_draws`` from the initial parameters
    (``params0.*``), data and draws of ``d``, under ``PINC_TRAIN`` with
    ``overrides``; fewer ``rollout_windows`` keep the first of each draw."""
    from bluerov2_dynamics_tpu_torch import convert
    from bluerov2_dynamics_tpu_torch.models import pinc

    tc = pinc.TrainConfig(**{**PINC_TRAIN, **overrides})
    starts = d["starts"][..., :tc.rollout_windows]
    net = convert.pinc_params_from_numpy(nested(d, "params0"), d["mu"], d["sigma"], PINC_HIDDEN,
                                         position_invariant=True, device="cpu")
    data = pinc.PINcData(*(torch.from_numpy(np.array(d[k])) for k in ("z", "y", "u4")))
    return pinc.train_from_draws(net, data, zip(d["perms"], starts), tc, mesh=mesh)


def pinc_checks(mesh) -> dict:
    """Data-parallel PINc training on this rank: with the windows split
    over the ranks (8 of them) and with every rank taking all (6), and
    the refusal of a batch that does not divide over the ranks."""
    d = dict(np.load(os.environ[PINC_INPUTS]))
    out = {}
    for w in (8, 6):
        net, hist = pinc_train(d, mesh, rollout_windows=w)
        out[f"pinc_w{w}"] = (hist, {k: v.numpy() for k, v in net.state_dict().items()})
    out["pinc_indivisible"] = _error(lambda: pinc_train(d, mesh, batch=62))
    return out


def linear_step(d):
    A, B = torch.as_tensor(d["A"]), torch.as_tensor(d["B"])
    return lambda x, u: x @ A + u @ B


def fossen_step():
    from bluerov2_dynamics_tpu_torch.models import fossen, params
    return fossen.make_wrench_step(params.fossen_params(dtype=torch.float64, device="cpu"),
                                   DT, "rk4")


def bank_model(d):
    """``(step, h, Q, R, P0)`` of the filter-bank checks (float64)."""
    eye = lambda k: torch.eye(k, dtype=torch.float64)  # noqa: E731
    return linear_step(d), (lambda x: x[:2]), eye(3) * 1e-4, eye(2) * 1e-2, eye(3) * 0.1


def bank_args(d, B: int, pf: bool = False):
    """``(m0, U, Y)`` of the bank of the first ``B`` trajectories (the PF's
    cut to ``BANK_T_PF`` steps)."""
    T = BANK_T_PF if pf else BANK_T
    return d["bank_m0"][:B], d["bank_U"][:B, :T - 1], d["bank_Y"][:B, :T]


def bank_checks(d, mesh) -> dict:
    """The sharded EKF and PF banks on this rank (each the whole bank's
    result, as numpy), and the error of a bank with a short ``U``."""
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    step, h, Q, R, P0 = bank_model(d)
    out = {}
    for B in BANK_SIZES:
        m0, U, Y = bank_args(d, B)
        res = sharded.sharded_ekf_bank(mesh, step, h, Q, R, m0, P0, U, Y)
        out[f"ekf_bank_{B}"] = [t.numpy() for t in res]
        m0, U, Y = bank_args(d, B, pf=True)
        res = sharded.sharded_pf_bank(mesh, step, h, Q, R, m0, P0, U, Y, seed=BANK_SEED,
                                      n_particles=BANK_PARTICLES)
        out[f"pf_bank_{B}"] = [t.numpy() for t in res]
    m0, U, Y = bank_args(d, 16)
    out["bank_short_u"] = _error(lambda: sharded.sharded_ekf_bank(
        mesh, step, h, Q, R, m0, P0, U[:, :-1], Y))
    return out


def mppi_runs(d, mesh=None) -> dict:
    """``simulate_mppi`` on ``d``'s linear plant at each of MPPI_SAMPLES,
    with ``mesh`` or in one process: ``(X, U)`` as numpy, keyed
    ``"mppi_<n>"``."""
    from bluerov2_dynamics_tpu_torch.models import control

    A, B = torch.as_tensor(d["mppi_A"]), torch.as_tensor(d["mppi_B"])
    x0 = torch.as_tensor(d["mppi_x0"])
    out = {}
    for n in MPPI_SAMPLES:
        X, U = control.simulate_mppi(lambda x, u: x @ A.T + torch.tanh(u) @ B.T, x0,
                                     torch.zeros(3, dtype=torch.float64), n_samples=n,
                                     dtype=torch.float64, device="cpu", mesh=mesh, **MPPI_KW)
        out[f"mppi_{n}"] = (X.numpy(), U.numpy())
    return out


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def all_checks(rank: int, world: int) -> dict:
    """Every port-side value the 4-rank tests compare, computed on this
    rank of a gloo group on CPU tensors."""
    from bluerov2_dynamics_tpu_torch.models import params
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    d = {k: torch.from_numpy(v) for k, v in inputs().items()}
    mesh = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    p32 = params.fossen_params(device="cpu")
    cfg, lag = params.thruster_config(device="cpu"), params.lag_params(DT, device="cpu")
    out = {"rank": (rank, world)}
    launches = dict(_build.launches)
    H = H_WINDOW
    out["k7_thruster"] = float(sharded.shardmap_endpoint_rmse_cuda(
        mesh, p32, cfg, lag, d["X12"], d["U8"], DT, H))
    out["k7_wrench"] = float(sharded.shardmap_endpoint_rmse_cuda_wrench(
        mesh, p32, d["X12"], d["TAU6"], DT, H))
    out["k7_quat"] = float(sharded.shardmap_endpoint_rmse_cuda_quat(
        mesh, p32, d["X13"], d["TAU6"], DT, H))
    out["k7_launched"] = _build.launches != launches
    out["k7_nan"] = float(sharded.shardmap_endpoint_rmse_cuda_wrench(
        mesh, p32, d["X12"][:8], d["TAU6"][:8], DT, 8))
    out["k7_indivisible"] = _error(lambda: sharded.shardmap_endpoint_rmse_cuda_quat(
        mesh, p32, d["X13"][:-1], d["TAU6"][:-1], DT, H))

    lin = linear_step(d)
    for H in (4, 9):
        out[f"lin_sharded_H{H}"] = float(sharded.sharded_endpoint_rmse(
            mesh, lin, d["X_lin"], d["U_lin"], H))
    out["lin_shardmap"] = float(sharded.shardmap_endpoint_rmse(mesh, lin, d["X_div"],
                                                               d["U_div"], 8))
    out["lin_indivisible"] = _error(lambda: sharded.shardmap_endpoint_rmse(
        mesh, lin, d["X_div"], d["U_div"], 7))
    out["lin_nan"] = [float(f(mesh, lin, d["X_div"], d["U_div"], H)) for H in (104, 110)
                      for f in (sharded.sharded_endpoint_rmse, sharded.shardmap_endpoint_rmse)]

    step = fossen_step()
    out["fossen_rollout"] = sharded.sharded_rollout_final(
        mesh, step, d["x0"], d["TAU_roll"], 25).numpy()
    out["fossen_rollout_uneven"] = sharded.sharded_rollout_final(
        mesh, step, d["x0"][:62], d["TAU_roll"], 25).numpy()
    out["fossen_shardmap"] = float(sharded.shardmap_endpoint_rmse(
        mesh, step, d["X_fossen"], d["TAU_fossen"], H_FOSSEN))
    out["fossen_sharded_uneven"] = float(sharded.sharded_endpoint_rmse(
        mesh, step, d["X_fossen"][:-2], d["TAU_fossen"][:-2], H_FOSSEN))

    mesh2 = pmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out["mesh2d"] = mesh2.mesh.tolist()
    out["mesh2d_coord"] = (mesh2.get_local_rank("data"), mesh2.get_local_rank("model"))
    x = torch.arange(10.0)
    out["shard_data"] = pmesh.shard_along(mesh2, x, "data").tolist()
    out["shard_model"] = pmesh.shard_along(mesh2, x, "model").tolist()
    mine = {"a": torch.full((3,), float(rank)), "b": (torch.tensor([rank, 2 * rank]),)}
    rep = pmesh.replicate(mesh, mine)
    out["replicated"] = (rep["a"].tolist(), rep["b"][0].tolist(), mine["a"].tolist())
    out["mesh_bad_shape"] = _error(lambda: pmesh.make_mesh((3,), ("data",), device_type="cpu"))
    out.update(koopman_checks(d, mesh, mesh2))
    out.update(pinc_checks(mesh))
    out["sysid"] = sysid_fits(d, mesh)
    out.update(bank_checks(d, mesh))
    out.update(mppi_runs(d, mesh))
    return out


def hang_on_rank_1(rank: int, world: int):
    """Rank 1 never returns; the others wait for it in a collective."""
    import time
    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.all_reduce(torch.zeros(1))
    return rank


def die_on_rank_2(rank: int, world: int):
    """Rank 2 exits with code 3 once every rank has joined the group (a
    death while the others still connect to it makes them raise first)."""
    import os
    import torch.distributed as dist
    dist.barrier()
    if rank == 2:
        os._exit(3)
    return rank


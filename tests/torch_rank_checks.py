"""Inputs and rank-side work of ``tests/test_torch_parallel.py``.

A module of its own, importing torch, numpy and the port only, because
``parallel.launch.run_ranks`` starts each rank in a fresh interpreter that
imports the function it runs by its module: the ranks then never import
JAX.  The inputs are made with numpy from a seed, so that the ranks and
the JAX side of the test build the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

DT = 0.02
WORLD = 4
H_WINDOW = 10                      # __graft_entry__.dryrun_multichip stages 5 and 6
N_WINDOW = 32 * WORLD + H_WINDOW
H_FOSSEN = 5


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
    return d


def linear_step(d):
    A, B = torch.as_tensor(d["A"]), torch.as_tensor(d["B"])
    return lambda x, u: x @ A + u @ B


def fossen_step():
    from bluerov2_dynamics_tpu_torch.models import fossen, params
    return fossen.make_wrench_step(params.fossen_params(dtype=torch.float64, device="cpu"),
                                   DT, "rk4")


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
    import os
    if rank == 2:
        os._exit(3)
    return rank


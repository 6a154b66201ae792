"""Process-group and device-mesh helpers for running on several ranks.

Counterpart of ``bluerov2_dynamics_tpu/parallel/mesh.py``.  The JAX package
lays its devices out as a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; here each rank is one process of a ``torch.distributed``
group, the mesh is a ``DeviceMesh`` over the ranks of the default group,
and the sharded functions (:mod:`.sharded`) call the collectives
themselves.  The natural parallel axis is the batch of rollout starts
('data'), with a 'model' axis kept for the layouts the JAX package uses.

The backend is always the caller's choice: ``"nccl"`` for CUDA tensors,
``"gloo"`` for CPU ones (gloo also reduces CUDA tensors, through the host).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_group(backend: str, device=None) -> None:
    """Start the default process group.

    Without ``WORLD_SIZE`` in the environment this is a one-process group
    (rank 0 of 1) on an in-process ``dist.HashStore()``, which is how a
    single program runs the sharded functions at world 1.  With it, the
    group is read from the environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), as a launcher sets them.
    ``device`` (a CUDA device) is made current and bound to the group.
    """
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    kw = {}
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
            kw["device_id"] = device
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default group, ranks laid
    out in order.  The default shape puts them all on the first axis:
    ``(world, 1, ...)``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "bluerov2_dynamics_tpu_torch.parallel.mesh.init_group(backend)")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axis_names)


def axis(mesh: DeviceMesh, axis_name: str):
    """``(group, size, index)`` of this rank along ``axis_name``."""
    dim = mesh.mesh_dim_names.index(axis_name)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def shard_along(mesh: DeviceMesh, x, axis_name: str = "data", dim: int = 0):
    """This rank's contiguous block of ``x`` along ``dim``, split over the
    ``axis_name`` axis as ``torch.tensor_split`` splits (the first
    ``len % size`` blocks one longer)."""
    _, size, index = axis(mesh, axis_name)
    return torch.tensor_split(x, size, dim=dim)[index]


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` (a tensor, or tuples, lists, dicts and
    NamedTuples of them) as the mesh's first rank holds it: each is
    broadcast from that rank to all ranks of the mesh.  Returns new
    tensors; the caller's are not written."""
    src = int(mesh.mesh.flatten()[0])

    def put(t):
        if isinstance(t, torch.Tensor):
            t = t.clone().contiguous()
            dist.broadcast(t, src=src)
            return t
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(put(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(put(v) for v in t)
        return t

    return put(tree)

"""Carry parameter containers into the port from plain numpy mappings.

The reference package's NamedTuples convert to the mapping these functions
take with ``{k: np.asarray(v) for k, v in p._asdict().items()}``; fitted
coefficients reach the port the same way, and so do a fitted Koopman
model's weights.  Values keep their dtype unless
``dtype`` is given.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models.koopman import KoopmanModel
from bluerov2_dynamics_tpu_torch.models.params import (
    FossenParams,
    LagParams,
    ThrusterConfig,
)


def _from_numpy(cls, fields: Mapping, dtype, device):
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {sorted(missing)}")
    device = resolve_device(device)
    return cls(*(
        torch.as_tensor(np.array(fields[k]), dtype=dtype, device=device)
        for k in cls._fields
    ))


def fossen_params_from_numpy(fields: Mapping, dtype=None, device=None) -> FossenParams:
    return _from_numpy(FossenParams, fields, dtype, device)


def thruster_config_from_numpy(fields: Mapping, dtype=None, device=None) -> ThrusterConfig:
    return _from_numpy(ThrusterConfig, fields, dtype, device)


def lag_params_from_numpy(fields: Mapping, dtype=None, device=None) -> LagParams:
    return _from_numpy(LagParams, fields, dtype, device)


def koopman_model_from_numpy(fields: Mapping, dtype=None, device=None) -> KoopmanModel:
    """A :class:`KoopmanModel` from the JAX model's arrays (``centers``,
    ``gamma``, ``A``, ``B``; ``decoder`` and ``rbf_weights`` where present
    and not None)."""
    missing = {"centers", "gamma", "A", "B"} - set(fields)
    if missing:
        raise KeyError(f"KoopmanModel needs fields {sorted(missing)}")
    device = resolve_device(device)
    return KoopmanModel(*(
        None if fields.get(k) is None
        else torch.as_tensor(np.array(fields[k]), dtype=dtype, device=device)
        for k in KoopmanModel._fields
    ))

"""Carry parameter containers into the port from plain numpy mappings.

The reference package's NamedTuples convert to the mapping these functions
take with ``{k: np.asarray(v) for k, v in p._asdict().items()}``; fitted
coefficients reach the port the same way, and so do a fitted Koopman
model's weights, DI gains and a PINc network's flax parameters.  Values
keep their dtype unless ``dtype`` is given.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models.di import DIGains
from bluerov2_dynamics_tpu_torch.models.koopman import KoopmanModel
from bluerov2_dynamics_tpu_torch.models.pinc import PINcNet, load_checked
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


def di_gains_from_numpy(fields: Mapping, dtype=None, device=None) -> DIGains:
    """:class:`DIGains` from the JAX gains' ``K_lin`` and ``K_ang``."""
    return _from_numpy(DIGains, fields, dtype, device)


def _flax_params(tree: Mapping) -> Mapping:
    """The ``{Dense_0: ..., ...}`` level of flax variables, whether or not
    they sit under a ``"params"`` key."""
    return tree["params"] if "params" in tree and "Dense_0" not in tree else tree


def pinc_params_from_numpy(tree: Mapping, norm_mu=None, norm_sigma=None, hidden=None,
                           position_invariant: bool = False, ln_eps: float = 1e-6,
                           dtype=torch.float32, device=None) -> PINcNet:
    """A :class:`PINcNet` from flax's PINc parameters as numpy arrays:
    ``{Dense_i: {kernel, bias}, AdaptiveSoftplus_i: {beta}, LayerNorm_i:
    {scale, bias}}``, alone or under ``"params"``.  A Dense kernel ``(in,
    out)`` becomes a Linear weight ``(out, in)``; the LayerNorm scale its
    weight.  ``hidden`` defaults to the kernels' widths; shapes that
    differ from ``PINcNet(hidden)``'s raise ``ValueError``."""
    p = _flax_params(tree)
    n_hidden = sum(1 for k in p if k.startswith("Dense_")) - 1
    if hidden is None:
        hidden = [np.shape(p[f"Dense_{i}"]["kernel"])[1] for i in range(n_hidden)]
    if len(hidden) != n_hidden:
        raise ValueError(f"the parameters hold {n_hidden} hidden layers, not {len(hidden)}")
    sd = {}
    for i in range(n_hidden):
        sd[f"net.{3 * i}.weight"] = np.asarray(p[f"Dense_{i}"]["kernel"]).T
        sd[f"net.{3 * i}.bias"] = p[f"Dense_{i}"]["bias"]
        sd[f"net.{3 * i + 1}.beta"] = p[f"AdaptiveSoftplus_{i}"]["beta"]
        sd[f"net.{3 * i + 2}.weight"] = p[f"LayerNorm_{i}"]["scale"]
        sd[f"net.{3 * i + 2}.bias"] = p[f"LayerNorm_{i}"]["bias"]
    sd[f"net.{3 * n_hidden}.weight"] = np.asarray(p[f"Dense_{n_hidden}"]["kernel"]).T
    sd[f"net.{3 * n_hidden}.bias"] = p[f"Dense_{n_hidden}"]["bias"]
    net = PINcNet(hidden, norm_mu, norm_sigma, position_invariant, ln_eps).to(dtype)
    return load_checked(net, sd, "the parameters").to(resolve_device(device))


def pinc_params_to_numpy(net: PINcNet) -> dict:
    """The inverse of :func:`pinc_params_from_numpy`: flax's variables
    ``{"params": {Dense_i: ..., AdaptiveSoftplus_i: ..., LayerNorm_i: ...}}``
    as numpy arrays in the net's dtype."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    n_hidden = len(net.hidden)
    dense = lambda j: {"kernel": sd[f"net.{j}.weight"].T.copy(), "bias": sd[f"net.{j}.bias"]}  # noqa: E731
    p = {f"Dense_{n_hidden}": dense(3 * n_hidden)}
    for i in range(n_hidden):
        p[f"Dense_{i}"] = dense(3 * i)
        p[f"AdaptiveSoftplus_{i}"] = {"beta": sd[f"net.{3 * i + 1}.beta"]}
        p[f"LayerNorm_{i}"] = {"scale": sd[f"net.{3 * i + 2}.weight"],
                               "bias": sd[f"net.{3 * i + 2}.bias"]}
    return {"params": p}

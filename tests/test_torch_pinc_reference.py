"""The port's PINc training (``models/pinc.py``) against the benchmark's plain
reference (``portbench/reference/pinc.py``), which is written from the
configuration file and imports nothing of the port: the dataset, the
forward, each of the three losses, the gradient of their sum and three
minibatches of ``train_from_draws``, on seeded random weights at the
published widths (64 x 4), minibatches of 32 and 4 windows of 3 steps.
CPU only, no JAX.

Tolerances (measured values in brackets):
- float64 (the port in float64 against the reference): the dataset at
  rtol 1e-12, atol 1e-12 [2.5e-14 abs on wrenches up to 17.5]; the
  forward at 1e-12 of max(1, |x|) [3.6e-15], the losses at rtol 1e-12
  [3.3e-15], the gradient at 1e-12 of its largest entry [3.6e-15]; three
  updates, the losses at rtol 1e-12 [4.7e-15], the parameters at atol
  1e-12 [7.9e-15].
- float32 (the port as it runs, on its float32 dataset, against the
  float64 reference): the forward at 1e-5 of max(1, |x|) [1.4e-6]; the
  losses at rtol 1e-5 [2.6e-7]; the gradient at 1e-4 of its largest entry
  [1.5e-6]; three updates, the losses at rtol 3e-5 [3.3e-6] and the
  parameters at atol 1e-5 [3.4e-7], against a move of 9.0e-3 (Adam's
  first steps are near sign(g) * lr a step).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.models import pinc
from portbench import recording
from portbench.reference import pinc as rp

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench/configs/bluerov2-heavy-pinc.json").read_text())
TRAFFIC = json.loads((ROOT / "portbench/traffic/pinc-epoch.json").read_text())
F64, F32 = torch.float64, torch.float32
BATCH, WINDOWS, STEPS, UPDATES = 32, 4, 3, 3


@pytest.fixture(scope="module")
def case():
    """A 300-row recording, its float64 dataset from both sides, seeded
    random weights (beta and the LayerNorms perturbed from their start) and
    three minibatches' draws."""
    tr = json.loads(json.dumps(TRAFFIC))
    tr["recording"].update(rows=300, part="all")
    X, U = (torch.as_tensor(a) for a in recording.generate(CFG, tr, 2**31 + 18))
    dt = CFG["dt"]
    data = pinc.make_dataset(X, U, dt, tparams.thruster_config(dtype=F64, device="cpu"),
                             tparams.lag_params(dt, dtype=F64, device="cpu"))
    g = torch.Generator().manual_seed(18)
    net = pinc.init_params(g, CFG["pinc"]["hidden"], dtype=F64, norm_mu=np.zeros(14),
                           norm_sigma=np.ones(14), ln_eps=CFG["pinc"]["ln_eps"])
    with torch.no_grad():
        for m in net.net:
            if isinstance(m, pinc.AdaptiveSoftplus):
                m.beta.copy_(0.5 + torch.rand((), generator=g, dtype=F64))
            elif isinstance(m, pinc.FastVarLayerNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=g, dtype=F64))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g, dtype=F64))
    tc = pinc.TrainConfig(batch=BATCH, rollout_windows=WINDOWS, rollout_steps=STEPS)
    perm, starts = pinc.epoch_draws(g, data.z.shape[0], UPDATES, BATCH, tc)
    return dict(X=X, U=U, data=data, net=net, tc=tc, perm=perm, starts=starts,
                ref_data=rp.dataset(CFG, X, U))


def _port(case, dtype):
    """The port's net, data and reduced coefficients in ``dtype``."""
    net = pinc.init_params(None, CFG["pinc"]["hidden"], dtype=dtype, norm_mu=np.zeros(14),
                           norm_sigma=np.ones(14), ln_eps=CFG["pinc"]["ln_eps"])
    net.load_state_dict(case["net"].state_dict())
    if dtype == F64:
        data = case["data"]
    else:
        dt = CFG["dt"]
        data = pinc.make_dataset(case["X"].to(dtype), case["U"].to(dtype), dt,
                                 tparams.thruster_config(dtype=dtype, device="cpu"),
                                 tparams.lag_params(dt, dtype=dtype, device="cpu"))
    return net.to(dtype), data, tparams.reduced_params(dtype=dtype, device="cpu")


def _ref_params(case):
    return [p.detach().clone() for p in case["net"].parameters()]


def _batch(data, case, k=0):
    idx = case["perm"][k]
    widx = case["starts"][k][:, None] + torch.arange(STEPS + 1)
    return data.z[idx], data.y[idx], data.u4[idx], data.z[widx]


def test_dataset_float64(case):
    z, y, u4 = case["ref_data"]
    d = case["data"]
    for got, want in ((d.z, z), (d.y, y), (d.u4, u4)):
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_forward_losses_and_gradient(case, dtype):
    net, data, rcoef = _port(case, dtype)
    z_b, y_b, u4_b, z_win = _batch(data, case)
    pred = net(z_b)
    parts = (pinc.mse_loss(pred, y_b), pinc.physics_loss(rcoef, pred, u4_b),
             pinc.rollout_loss(net, z_win, STEPS))
    total = parts[0] + 0.5 * parts[1] + 1.0 * parts[2]
    grads = torch.autograd.grad(total, list(net.parameters()))

    params = [p.requires_grad_(True) for p in _ref_params(case)]
    rz, ry, ru4, rwin = _batch(pinc.PINcData(*case["ref_data"]), case)
    want_pred = rp.forward(CFG, params, rz)
    want_parts = rp.losses(CFG, params, rz, ry, ru4, rwin, STEPS)
    want_grads = torch.autograd.grad(rp.total_loss(CFG, want_parts), params)

    f64 = dtype == F64
    scale = torch.clamp_min(want_pred.detach().abs(), 1.0)
    gap = (pred.detach().double() - want_pred.detach()).abs() / scale
    assert float(gap.max()) < (1e-12 if f64 else 1e-5)
    for got, want in zip(parts, want_parts):
        want = float(want.detach())
        assert float(got.detach()) == pytest.approx(want, rel=1e-12 if f64 else 1e-5)
    g_got = torch.cat([g.reshape(-1).double() for g in grads])
    g_want = torch.cat([g.reshape(-1) for g in want_grads])
    assert float((g_got - g_want).abs().max() / g_want.abs().max()) < (1e-12 if f64 else 1e-4)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_three_updates_of_train_from_draws(case, dtype):
    net, data, rcoef = _port(case, dtype)
    draws = [(case["perm"], case["starts"])]
    net, history = pinc.train_from_draws(net, data, draws, case["tc"], rp=rcoef)
    want_hist, want_params = rp.train(CFG, _ref_params(case), case["ref_data"], draws, STEPS)
    f64 = dtype == F64
    assert history == pytest.approx(want_hist, rel=1e-12 if f64 else 3e-5)
    gap = np.abs(rp.flat(list(net.parameters())) - rp.flat(want_params)).max()
    assert gap < (1e-12 if f64 else 1e-5)
    # the updates moved the net by Adam's ~lr a step, far beyond the gap
    moved = np.abs(rp.flat(want_params) - rp.flat(_ref_params(case))).max()
    assert moved > 100 * max(gap, 1e-6)

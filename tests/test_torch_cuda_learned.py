"""The learned models (DI, PINc), the checkpoint reader and apps T6 and T4
on the card.

Every case needs a CUDA device and skips without one.  The file imports
no JAX, flax, optax or pandas (the card's machine has none of the last
three); the parity with the JAX package is the CPU tests' work
(``test_torch_di.py``, ``test_torch_pinc.py``, ``test_torch_checkpoint.py``,
``test_torch_learned_apps.py``).  Tolerances: the committed PINc's forward
on the card against the host CPU's at atol 1e-5 on outputs up to ~20
(float32 both, full float32 matmuls); its endpoint RMSE and the DI's at
rtol 1e-4; the checkpoint's parameters on the card bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.apps import tank_full_comparison, tank_wrench_quat
from bluerov2_dynamics_tpu_torch.data import synthetic as ts
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.models import di, pinc
from bluerov2_dynamics_tpu_torch.models.params import lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.ops import _build
from bluerov2_dynamics_tpu_torch.utils.checkpoint import load_pytree

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "pinc_best.msgpack"
DT = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the learned models and apps on the card")
    return torch.device("cuda")


def _committed(device):
    tree = load_pytree(CKPT)
    meta = json.loads(CKPT.with_suffix(".msgpack.json").read_text())
    return tree, convert.pinc_params_from_numpy(
        tree["params"], tree["norm_mu"], tree["norm_sigma"], meta["hidden"],
        position_invariant=meta["position_invariant"], device=device)


@pytest.mark.cuda
def test_checkpoint_reader_puts_the_committed_bits_on_card(cuda):
    tree, net = _committed(cuda)
    back = convert.pinc_params_to_numpy(net)["params"]
    for layer, leaves in tree["params"]["params"].items():
        for name, want in leaves.items():
            assert np.array_equal(back[layer][name], want), (layer, name)
    assert next(net.parameters()).device.type == "cuda"


@pytest.mark.cuda
def test_pinc_and_di_on_card_agree_with_the_cpu(cuda):
    _, net_card = _committed(cuda)
    _, net_cpu = _committed("cpu")
    rec = ts.generate_tank_recording(3, n_steps=1200, device="cpu")
    X, U = rec.X.float(), rec.U.float()
    cfg, lag = thruster_config(device="cpu"), lag_params(DT, device="cpu")
    U4 = pinc.wrench4_from_thrusters(cfg, lag, U)
    z = torch.cat([pinc.state12_to_9(X[:-1]), U4[:-1], torch.full((len(X) - 1, 1), DT)], dim=1)
    with torch.no_grad():
        got = net_card(z.to(cuda)).cpu()
        want = net_cpu(z)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    U4_card = pinc.wrench4_from_thrusters(thruster_config(device=cuda), lag_params(DT, device=cuda),
                                          U.to(cuda))
    np.testing.assert_allclose(U4_card.cpu().numpy(), U4.numpy(), rtol=1e-5, atol=1e-4)
    gains_cpu = di.estimate_gains(X, U, DT)
    gains_card = di.estimate_gains(X.to(cuda), U.to(cuda), DT)
    for H in (1, 10, 100):
        for mode in ("raw", "ssa"):
            np.testing.assert_allclose(
                float(pinc.endpoint_rmse(net_card, X.to(cuda), U4.to(cuda), DT, H, mode)),
                float(pinc.endpoint_rmse(net_cpu, X, U4, DT, H, mode)), rtol=1e-4)
        np.testing.assert_allclose(
            float(metrics.endpoint_rmse(di.make_step_euler12(gains_card, DT), X.to(cuda),
                                        U.to(cuda), H)),
            float(metrics.endpoint_rmse(di.make_step_euler12(gains_cpu, DT), X, U, H)),
            rtol=1e-4)


@pytest.mark.cuda
def test_t6_trains_saves_and_reloads_on_card(cuda, tmp_path):
    ckpt = tmp_path / "pinc.msgpack"
    args = ["--synthetic", "--recording", "--steps", "1500", "--n-rbfs", "32", "--no-media",
            "--pinc-epochs", "2", "--pinc-hidden", "16", "16", "--pinc-ckpt", str(ckpt),
            "--pinc-psi-ssa"]
    _build.reset_launch_counts()
    first = tank_full_comparison.main(args)
    assert _build.launches["window_sq"] == 6          # the Fossen row: 3 horizons, cold and warm
    assert ckpt.exists() and first["fit_s"]["pinc"] > 0.0
    again = tank_full_comparison.main(args)           # loads what the first run saved
    assert again["fit_s"]["pinc"] == 0.0
    for name in ("PINc (ResDNN)", "PINc (ssa psi)", "Double Integrator", "Fossen (BlueROV2)"):
        for H in (1, 10, 100):
            assert np.isfinite(first["rmse"][name][H]), (name, H)
            np.testing.assert_allclose(again["rmse"][name][H], first["rmse"][name][H], rtol=1e-6)


@pytest.mark.cuda
def test_t4_main_on_card(cuda):
    _build.reset_launch_counts()
    out = tank_wrench_quat.main(["--synthetic", "--steps", "1500", "--n-rbfs", "32",
                                 "--no-media"])
    assert _build.launches["window_sq_quat"] == 6
    assert list(out["rmse"]) == ["Koopman (quat)", "Fossen (quat)", "DI (quat)"]
    assert all(np.isfinite(v) for row in out["rmse"].values() for v in row.values())
    np.testing.assert_allclose(np.linalg.norm(out["di"][:, 3:7], axis=1), 1.0, atol=1e-5)

"""Wrench workload, Euler state (T3): the Fossen physics baseline's
endpoint evaluator.

Counterpart of the dataset conversion and the Fossen evaluator of
``bluerov2_dynamics_tpu/apps/tank_wrench_comp.py``: a 12-state recording
whose 8 thruster commands become a 6-D body wrench through the
BlueROV2-heavy effectiveness matrix (``data/wrench.py``).  The Koopman and
DI models and the app's command line come with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data.wrench import thrusters_to_wrench
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.models import fossen
from bluerov2_dynamics_tpu_torch.models.params import fossen_params
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import make_endpoint_sq_cuda_wrench


def wrench_dataset(X, U):
    """``(X (N, 12), U (N, 8))`` thruster recording -> ``(X, W (N, 6))``
    with the normalised body wrench of the recorded vehicle (host, numpy)."""
    return np.asarray(X), thrusters_to_wrench(np.asarray(U))


def fossen_wrench_evaluator(dt, X_test, TAU_test, method="euler", p=None, device=None):
    """``fn(H) -> endpoint RMSE`` of the wrench-input euler12 Fossen model.

    ``X_test (N, 12)`` and ``TAU_test (N, 6)`` move to ``device`` as
    float32 (``None`` means ``cuda``).  On CUDA the fused sliding-window
    kernel (K4, one launch) runs; on the CPU the batched step loop does.
    ``p`` defaults to the nominal Table A1 set.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    TAU_test = torch.as_tensor(TAU_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    step = fossen.make_wrench_step(p, dt, method=method, state="euler12")
    return common.endpoint_evaluator_with_kernel(
        X_test, TAU_test,
        build_kernel=lambda H: make_endpoint_sq_cuda_wrench(p, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse(step, X_test, TAU_test, H),
    )

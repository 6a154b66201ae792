"""Quaternion workload (T4): the quat13 Fossen physics baseline's endpoint
evaluator.

Counterpart of the dataset conversion and the Fossen evaluator of
``bluerov2_dynamics_tpu/apps/tank_wrench_quat.py``: a 12-state recording
becomes a 13-state quaternion recording (quaternions formed in float64 on
the host) with the 6-D body wrench of ``data/wrench.py``; the model
renormalises its quaternion after every step.  The Koopman and DI models
and the app's command line come with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.data.csv_loader import euler_to_quat_np
from bluerov2_dynamics_tpu_torch.data.wrench import thrusters_to_wrench
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.models import fossen
from bluerov2_dynamics_tpu_torch.models.params import fossen_params
from bluerov2_dynamics_tpu_torch.ops.cuda_quat import make_endpoint_sq_cuda_quat


def quat_dataset(X, U):
    """``(X (N, 12), U (N, 8))`` thruster recording -> ``(X13 (N, 13),
    W (N, 6))``: Euler angles to unit quaternions and thruster commands to
    the body wrench, in float64 on the host."""
    X = np.asarray(X, np.float64)
    q = euler_to_quat_np(X[:, 3], X[:, 4], X[:, 5])
    X13 = np.concatenate([X[:, 0:3], q, X[:, 6:12]], axis=1)
    return X13, thrusters_to_wrench(np.asarray(U, np.float64))


def fossen_quat_evaluator(dt, X_test, TAU_test, method="euler", p=None, device=None):
    """``fn(H) -> endpoint RMSE`` of the quat13 wrench-input Fossen model,
    renormalised after every step.

    ``X_test (N, 13)`` and ``TAU_test (N, 6)`` move to ``device`` as
    float32 (``None`` means ``cuda``).  On CUDA the fused sliding-window
    kernel (K5, one launch) runs; on the CPU the batched step loop does.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    TAU_test = torch.as_tensor(TAU_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    step = fossen.make_wrench_step(p, dt, method=method, state="quat13")
    return common.endpoint_evaluator_with_kernel(
        X_test, TAU_test,
        build_kernel=lambda H: make_endpoint_sq_cuda_quat(p, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse(step, X_test, TAU_test, H),
    )

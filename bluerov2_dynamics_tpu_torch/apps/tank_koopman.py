"""Tank workload (T2): the Fossen physics baseline's endpoint evaluator.

Counterpart of ``fossen_evaluator`` in
``bluerov2_dynamics_tpu/apps/tank_koopman.py``.  The Koopman fit and the
app's command line come with ROADMAP Queue 1 item 10 (the learned models).
"""

from __future__ import annotations

import torch

from bluerov2_dynamics_tpu_torch.apps import common
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval import metrics
from bluerov2_dynamics_tpu_torch.models import fossen
from bluerov2_dynamics_tpu_torch.models.params import (
    fossen_params,
    lag_params,
    thruster_config,
)
from bluerov2_dynamics_tpu_torch.ops.cuda_eval import make_endpoint_sq_cuda


def fossen_evaluator(dt, X_test, U_test, method="euler", p=None, cfg=None,
                     device=None):
    """``fn(H) -> endpoint RMSE`` of the full thruster-input physics model.

    ``X_test (N, 12)`` and ``U_test (N, 8)`` move to ``device`` as float32
    (``None`` means ``cuda``).  On CUDA the fused sliding-window kernel
    (K2, one launch that returns the summed squared error) runs; on the
    CPU the batched step loop does.  ``p``/``cfg`` default to the
    nominal Table A1 set; fitted values go through the same path, since
    the kernel takes its coefficients at launch.
    """
    device = resolve_device(device)
    X_test = torch.as_tensor(X_test, dtype=torch.float32, device=device).contiguous()
    U_test = torch.as_tensor(U_test, dtype=torch.float32, device=device).contiguous()
    p = p.to(device) if p is not None else fossen_params(device=device)
    cfg = cfg.to(device) if cfg is not None else thruster_config(device=device)
    lag = lag_params(dt, device=device)
    step = fossen.make_thruster_step(p, cfg, lag, dt, method=method)
    return common.endpoint_evaluator_with_kernel(
        X_test, U_test,
        build_kernel=lambda H: make_endpoint_sq_cuda(p, cfg, lag, dt, H, method=method),
        scan_eval=lambda H: metrics.endpoint_rmse_carry(
            step,
            lambda x: torch.zeros((*x.shape[:-1], 8, 3), dtype=x.dtype, device=x.device),
            X_test, U_test, H,
        ),
    )

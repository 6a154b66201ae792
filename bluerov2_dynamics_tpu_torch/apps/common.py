"""Pieces shared by the port's apps.

Counterpart of the evaluator policy in ``bluerov2_dynamics_tpu/apps/common.py``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def fused_rmse(sq_fn: Callable, X, U, H: int):
    """Endpoint RMSE from a fused window evaluator (``make_endpoint_sq_cuda*``:
    ``(X, U) ->`` the squared endpoint error summed over the ``N - H``
    starts): ``sqrt(sq / ((N - H) n))``."""
    N, n = X.shape
    return torch.sqrt(sq_fn(X, U) / ((N - H) * n))


def endpoint_evaluator_with_kernel(X_test, U_test, build_kernel: Callable,
                                   scan_eval: Callable) -> Callable:
    """Physics-baseline evaluator policy: ``fn(H) -> endpoint RMSE``.

    The policy follows the device of ``X_test``: on CUDA the fused window
    evaluator built by ``build_kernel(H)`` runs, one kernel launch and a
    sqrt (:func:`fused_rmse`; evaluators cached per H, so warm timings stay
    warm); on the CPU ``scan_eval(H)`` runs.  ``H >= len(X_test)`` returns
    NaN.
    """
    use_kernel = X_test.is_cuda
    cache: Dict[int, Callable] = {}

    def run(H: int):
        if X_test.shape[0] - H <= 0:
            return torch.tensor(float("nan"), dtype=X_test.dtype, device=X_test.device)
        if use_kernel:
            if H not in cache:
                cache[H] = build_kernel(H)
            return fused_rmse(cache[H], X_test, U_test, H)
        return scan_eval(H)

    return run

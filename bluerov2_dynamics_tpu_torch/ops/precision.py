"""Full float32 GEMMs, whatever the caller's settings.

The Koopman lifts, k-means distances and propagations multiply raw state
values (an unwound psi reaches tens of radians), where TF32's 10-bit
mantissa cancels catastrophically in the Gram-expansion distances and
skews multi-step metrics (the JAX package's ``ops/lifting.py`` and
``models/koopman.py:521-527`` describe both failures).  :func:`full_f32`
pins ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` for the duration of a
block or call and restores the caller's values afterwards.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_f32():
    """Context (and decorator) that runs its body with TF32 matmuls off."""
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def tf32_enabled() -> bool:
    """Whether a float32 matmul issued now may run in TF32."""
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")

"""k-means on the device: k-means++ seeding, then Lloyd rounds.

Counterpart of ``bluerov2_dynamics_tpu/ops/kmeans.py``.  The distances are
one GEMM a round (``|x|^2 - 2 x C^T + |c|^2``, full float32, clamped at
zero) and the center update is a one-hot GEMM, which gives the same bits on
every call (``index_add_`` on CUDA adds by atomics, in no fixed order).
Empty clusters keep their center; ``argmin`` takes the first minimum, as
JAX's does.  The seeding draws from a ``torch.Generator``, not from JAX's
threefry stream, so the port's centers for a seed are not the JAX
package's: ``init=`` takes initial centers (for example JAX's own
k-means++ result) and runs the Lloyd rounds from them.
"""

from __future__ import annotations

from typing import Optional

import torch

from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.utils.profiling import span


@full_f32()
def _pairwise_sqdist(X, C):
    """Squared Euclidean distances ``(N, k)`` by the Gram expansion."""
    x2 = torch.sum(X * X, dim=1)[:, None]
    c2 = torch.sum(C * C, dim=1)[None, :]
    cross = X @ C.T
    return torch.clamp(x2 + c2 - 2.0 * cross, min=0.0)


def _kmeanspp_init(X, k: int, generator: Optional[torch.Generator] = None):
    """k-means++ seeding: each next center is a point drawn with probability
    proportional to its squared distance from the nearest center so far
    (uniform where every distance is zero).  ``generator`` lives on
    ``X``'s device; the loop makes no host synchronisation."""
    N = X.shape[0]
    first = X.index_select(0, torch.randint(0, N, (1,), generator=generator,
                                            device=X.device))[0]
    centers = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    centers[0] = first
    min_d = torch.sum((X - first) ** 2, dim=1)
    uniform = torch.full_like(min_d, 1.0 / N)
    for i in range(1, k):
        total = torch.sum(min_d)
        p = torch.where(total > 0, min_d / total, uniform)
        c = X.index_select(0, torch.multinomial(p, 1, generator=generator))[0]
        centers[i] = c
        min_d = torch.minimum(min_d, torch.sum((X - c) ** 2, dim=1))
    return centers


@full_f32()
def kmeans(X, k: int, iters: int = 25, generator: Optional[torch.Generator] = None,
           init=None):
    """Cluster ``X (N, n)`` into ``k`` centers; returns ``(centers, assign)``.

    Seeds by :func:`_kmeanspp_init` from ``generator`` unless ``init``
    (``(k, n)`` initial centers) is given, then runs ``iters`` Lloyd
    rounds.  Deterministic for a generator's seed.  The seeding and the
    rounds (with the final assignment) are the spans ``brov2.koopman.seed``
    and ``brov2.koopman.lloyd``.
    """
    if init is None:
        with span("brov2.koopman.seed"):
            centers = _kmeanspp_init(X, k, generator)
    else:
        centers = torch.as_tensor(init, dtype=X.dtype, device=X.device).clone()
    with span("brov2.koopman.lloyd"):
        for _ in range(iters):
            assign = torch.argmin(_pairwise_sqdist(X, centers), dim=1)
            onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)   # (N, k)
            counts = torch.sum(onehot, dim=0)                             # (k,)
            sums = onehot.T @ X                                           # (k, n)
            centers = torch.where(counts[:, None] > 0,
                                  sums / torch.clamp(counts, min=1.0)[:, None], centers)
        assign = torch.argmin(_pairwise_sqdist(X, centers), dim=1)
    return centers, assign

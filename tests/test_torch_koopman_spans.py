"""The Koopman fit's and scoring's spans (``utils/profiling.py::span``):
under a profiler each opens once for each call it wraps; with no profiler
running, and under one, the fit's centers, A and B and the endpoint RMSEs
are bit for bit those of the same arithmetic composed without spans.  CPU
only, no JAX."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.models import koopman
from bluerov2_dynamics_tpu_torch.ops import kmeans as km
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift

N, K, ITERS, GAMMA, RIDGE, SEED = 600, 16, 5, 3.0, 0.1, 7
HORIZONS = (1, 5, 20)


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(22)
    X = torch.randn(N, 12, generator=g)
    X[:, 5] += torch.linspace(0, 20, N)
    return X, 2 * torch.rand(N, 8, generator=g) - 1


def _run(X, U):
    """A seeded fit and its scoring at every horizon, through the port."""
    m = koopman.fit(torch.Generator().manual_seed(SEED), X, U, n_rbfs=K, gamma=GAMMA,
                    ridge=RIDGE, kmeans_iters=ITERS)
    return (m.centers, m.A, m.B), [koopman.multistep_rmse(m, X, U, H) for H in HORIZONS]


def _run_without_spans(X, U):
    """The same arithmetic composed from the port's pieces, with no span."""
    centers = km._kmeanspp_init(X, K, torch.Generator().manual_seed(SEED))
    for _ in range(ITERS):
        assign = torch.argmin(km._pairwise_sqdist(X, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, K).to(X.dtype)
        counts = torch.sum(onehot, dim=0)
        centers = torch.where(counts[:, None] > 0,
                              onehot.T @ X / torch.clamp(counts, min=1.0)[:, None], centers)
    gamma = torch.as_tensor(GAMMA, dtype=X.dtype)
    Z, Zp = rbf_lift(X[:-1], centers, gamma), rbf_lift(X[1:], centers, gamma)
    G = torch.cat([Z, U[:-1]], dim=1)
    M = koopman._solve_normal_eqns(*koopman._gram(G, Zp), RIDGE).to(G.dtype)
    d = Z.shape[1]
    A, B = M[:d].T, M[d:].T
    out = []
    for H in HORIZONS:
        n_start = N - H
        Z0 = rbf_lift(X[:n_start], centers, gamma)
        for t in range(H):
            Z0 = Z0 @ A.T + U[t:t + n_start] @ B.T
        out.append(rmse(X[H:], Z0[:, :12]))
    return (centers, A, B), out


def _same_bits(a, b):
    (fa, ra), (fb, rb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))


def test_spans_open_once_for_each_call(data):
    X, U = data
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit, _ = _run(X, U)
        model = koopman.KoopmanModel(fit[0], torch.tensor(GAMMA), fit[1], fit[2])
        koopman.multistep_rmse(model, X, U, 4, method="conv")
        koopman.multistep_rmse(model, X, U, 0)
        koopman.fit(None, X, U, n_rbfs=K, gamma=GAMMA, ridge=RIDGE, kmeans_iters=2,
                    init=fit[0])
    n = Counter(e.name for e in prof.events() if e.name.startswith("brov2.koopman."))
    # two fits (the second from given centers, so not seeded), five scorings
    # (H = 0 propagates nothing)
    assert n == {"brov2.koopman.seed": 1, "brov2.koopman.lloyd": 2, "brov2.koopman.lift": 2,
                 "brov2.koopman.normal_eqns": 2, "brov2.koopman.propagate": 4}


def test_spans_change_no_bit(data):
    X, U = data
    want = _run_without_spans(X, U)
    _same_bits(_run(X, U), want)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run(X, U)
    _same_bits(traced, want)

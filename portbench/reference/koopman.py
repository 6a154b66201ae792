"""Plain reference of the Koopman EDMDc model, from a configuration's numbers.

EDMDc with a Gaussian-RBF dictionary as ViktorNfa/bluerov2_dynamics fits it
(``Koopman/koopmanEDMDc.py:54-248``; T2's settings in
``training/train_tank_brov2_koopmanEDMDc.py``): the lift ``phi(x) = [x,
exp(-gamma |x - c_1|^2), ..., exp(-gamma |x - c_k|^2)]`` over ``k`` centers
from k-means of the state cloud, the lifted linear model ``z+ = A z + B u``
fitted by ridge regression over consecutive snapshot pairs, and the first
``n`` lifted coordinates read back as the state.  Written here from that
description and the configuration file, not from the port, as plain tensor
arithmetic:

* squared distances by the Gram expansion ``|x|^2 + |c|^2 - 2 x.c``,
  clamped at 0;
* Lloyd rounds from given initial centers: each row to its nearest center
  (the first of equals), each center the mean of its rows, a center with no
  rows kept where it was;
* the ridge normal equations ``(G^T G + ridge I) M = G^T Z+`` with ``G =
  [Z, U]``, summed over blocks of pairs and solved by Cholesky (``NaN``
  where the factorisation fails);
* every start's endpoint after ``H`` steps of ``z A^T + u B^T``, a block of
  starts at a time, and its RMSE over the ``n`` states;
* the k-means objective, each row's squared distance to its nearest center
  summed over the rows;
* a k-means++ draw of its own: the first row uniform, each next row with
  probability proportional to its squared distance to the nearest row drawn
  so far.

The k-means++ seeding is random: the fit starts its Lloyd rounds from seed
rows it is given, and its own draw, from a generator of its own, stands only
for the objective a D^2-weighted draw reaches.  Its departures from the published code are the configuration's
``assumed``.  Everything runs in the :class:`~portbench.reference.fossen.
Precision` it is given, on the device of its inputs: ``F64`` in float64;
the control ``TF32`` rounds each GEMM's operands and result (the distances,
the rounds' sums, the lifts, the propagation) to TF32 and forms and solves
the normal equations in float32, the precisions below the configuration's.
It imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.fossen import F64, Precision

BLOCK = 4096                  # rows, pairs or starts a block


class Model(NamedTuple):
    centers: torch.Tensor     # (k, n)
    A: torch.Tensor           # (d, d)
    B: torch.Tensor           # (d, r)


def settings(cfg: dict) -> dict:
    """The configuration's ``koopman`` block, checked against what the
    reference computes (the full-state distance, the first-n readout)."""
    k = cfg["koopman"]
    if k["position_invariant"] or k["decoder"] != "first_n":
        raise ValueError(f"{cfg['name']}: the reference lifts every state coordinate and "
                         "reads the first n lifted coordinates back")
    n, r, m = int(k["state_width"]), int(k["input_width"]), int(k["n_rbfs"])
    if (int(k["lift_dim"]), int(k["gram_width"])) != (n + m, n + m + r):
        raise ValueError(f"{cfg['name']}: lift_dim and gram_width do not follow from the widths")
    return k


def _mm(prec: Precision, a, b):
    return prec.r(prec.r(a) @ prec.r(b))


def sqdist(X, C, prec: Precision = F64):
    """``(N, k)`` squared distances of the rows of ``X`` to the centers ``C``
    by the Gram expansion, clamped at 0."""
    x2 = prec.r(torch.sum(X * X, dim=1, keepdim=True))
    c2 = prec.r(torch.sum(C * C, dim=1))
    return torch.clamp(prec.r(x2 + c2 - 2.0 * _mm(prec, X, C.T)), min=0.0)


def lift(cfg: dict, X, centers, prec: Precision = F64):
    """``phi(X)``: ``(N, n) -> (N, n + k)``."""
    gamma = float(settings(cfg)["gamma"])
    return torch.cat([X, prec.r(torch.exp(-gamma * sqdist(X, centers, prec)))], dim=1)


def lloyd(cfg: dict, X, init, prec: Precision = F64):
    """The configuration's ``kmeans_iters`` Lloyd rounds from ``init (k, n)``."""
    C = init.clone()
    k = C.shape[0]
    for _ in range(int(settings(cfg)["kmeans_iters"])):
        assign = torch.cat([torch.argmin(sqdist(X[i:i + BLOCK], C, prec), dim=1)
                            for i in range(0, X.shape[0], BLOCK)])
        counts = torch.bincount(assign, minlength=k).to(X.dtype)
        sums = prec.r(torch.zeros_like(C).index_add_(0, assign, prec.r(X)))
        C = torch.where(counts[:, None] > 0, prec.r(sums / counts.clamp(min=1.0)[:, None]), C)
    return C


def objective(X, C, prec: Precision = F64) -> float:
    """The k-means objective of the centers ``C`` on the rows ``X``, summed
    in float64."""
    return float(sum(torch.min(sqdist(X[i:i + BLOCK], C, prec), dim=1).values.double().sum()
                     for i in range(0, X.shape[0], BLOCK)))


def kmeanspp(X, k: int, generator: torch.Generator, prec: Precision = F64):
    """``k`` rows of ``X`` drawn by k-means++ from ``generator`` (on ``X``'s
    device); the distances to each newest row directly, in ``prec``."""
    X = X.to(prec.dtype)
    N = X.shape[0]
    rows = [int(torch.randint(0, N, (1,), generator=generator, device=X.device))]
    nearest = prec.r(torch.sum(prec.r((X - X[rows[0]]) ** 2), dim=1))
    for _ in range(1, k):
        i = torch.multinomial(nearest / nearest.sum(), 1, generator=generator)
        rows.append(i)
        nearest = torch.minimum(nearest, prec.r(torch.sum(prec.r((X - X[i]) ** 2), dim=1)))
    return X[torch.cat([torch.as_tensor(rows[:1], device=X.device)] + rows[1:])]


def normal_equations(cfg: dict, X, U, centers, prec: Precision = F64) -> Model:
    """``A``, ``B`` of the ridge regression over the pairs ``(X[t], U[t]) ->
    X[t + 1]``."""
    ridge = float(settings(cfg)["ridge"])
    pairs = X.shape[0] - 1
    gram = rhs = 0.0
    for i in range(0, pairs, BLOCK):
        j = min(i + BLOCK, pairs)
        G = torch.cat([lift(cfg, X[i:j], centers, prec), U[i:j]], dim=1)
        Zp = lift(cfg, X[i + 1:j + 1], centers, prec)
        gram = gram + G.T @ G
        rhs = rhs + G.T @ Zp
    d = rhs.shape[1]
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    L, info = torch.linalg.cholesky_ex(gram + ridge * eye)
    M = torch.cholesky_solve(rhs, L)
    if int(info):
        M = torch.full_like(M, float("nan"))
    return Model(centers, M[:d].T, M[d:].T)


def fit(cfg: dict, X, U, seeds, prec: Precision = F64) -> Model:
    """The model fitted to ``X (N, n)``, ``U (N, r)`` from the k-means++ seed
    rows ``seeds (k, n)``."""
    X, U, seeds = (t.to(prec.dtype) for t in (X, U, seeds))
    return normal_equations(cfg, X, U, lloyd(cfg, X, seeds, prec), prec)


def endpoint_rmse(cfg: dict, model: Model, X, U, H: int, prec: Precision = F64) -> float:
    """RMSE over the ``n`` states of every start's endpoint after ``H``
    steps, against the recorded state ``H`` rows on."""
    model = Model(*(t.to(prec.dtype) for t in model))
    X, U = X.to(prec.dtype), U.to(prec.dtype)
    n, n_start = X.shape[1], X.shape[0] - H
    A_T, B_T = model.A.T, model.B.T
    sq = torch.zeros((), dtype=torch.float64, device=X.device)
    for i in range(0, n_start, BLOCK):
        j = min(i + BLOCK, n_start)
        z = lift(cfg, X[i:j], model.centers, prec)
        for t in range(H):
            z = prec.r(_mm(prec, z, A_T) + _mm(prec, U[i + t:j + t], B_T))
        e = (z[:, :n] - X[i + H:j + H]).double()
        sq += torch.sum(e * e)
    return float(torch.sqrt(sq / (n_start * n)))

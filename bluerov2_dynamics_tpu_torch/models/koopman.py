"""Koopman EDMDc system identification with an RBF dictionary (PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/models/koopman.py``:

* RBF centers from k-means on the device (:mod:`..ops.kmeans`);
* the ridge regression ``Z+ = A Z + B U`` solved as one Gram GEMM ``G^T G``
  and a Cholesky solve;
* multi-step evaluation and open-loop simulation as loops of GEMMs
  (``scan``), or the H-step endpoint as one batched control-convolution
  GEMM (``conv``);
* a streaming fit from sufficient statistics, with exponential
  forgetting, and a (gamma, ridge) sweep with NaN-guarded selection.

Every GEMM runs in full float32 or float64, never TF32 or bf16
(:func:`..ops.precision.full_f32` pins the settings around each public
function and restores the caller's).  The normal equations (the Gram
``G^T G``, ``G^T Y`` and their Cholesky solve) are formed and solved in
float64 whatever the data's dtype, and the solution is rounded back: at
the tank workload's shape (36,657 pairs, 500 RBFs) the JAX package's
float32 normal equations move the H-step RMSEs by up to 7% against
float64, which a float64 Gram of the same float32 lifts brings to 3e-4
(``PERF.md``; the lifts and propagations stay float32).  The Cholesky
solve uses
``torch.linalg.cholesky_ex`` and fills NaN where a factorisation fails,
as ``jax.scipy.linalg.solve(assume_a="pos")`` does: a Gram that is not
positive definite gives a NaN model, never an exception, so
:func:`select_best`'s NaN guard and :func:`fit_decoder`'s NaN mode behave
as in the JAX package.  Where the JAX functions take a PRNG key, these
take a ``torch.Generator`` on the data's device (k-means++ seeding), or
``init=`` centers.  The model is a NamedTuple of tensors; fitting is a
pure function.
"""

from __future__ import annotations

import io
import pathlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32
from bluerov2_dynamics_tpu_torch.utils.profiling import span


class KoopmanModel(NamedTuple):
    """Learned lifted-linear model ``z+ = A z + B u`` with readout.

    ``decoder`` is ``None`` for the first-n-coordinates readout, or an
    ``(n, d)`` linear decoder from :func:`fit_decoder`.  ``rbf_weights``
    are ``(n,)`` coordinate weights for the RBF distance (a 0/1 mask makes
    the dictionary invariant to the masked coordinates), or ``None``.
    """

    centers: torch.Tensor                   # (k, n)
    gamma: torch.Tensor                     # scalar RBF width
    A: torch.Tensor                         # (d, d)
    B: torch.Tensor                         # (d, r)
    decoder: Optional[torch.Tensor] = None  # (n, d) or None
    rbf_weights: Optional[torch.Tensor] = None

    @property
    def state_dim(self) -> int:
        return self.centers.shape[-1]

    @property
    def lift_dim(self) -> int:
        return self.A.shape[-1]


def lift(model: KoopmanModel, X):
    """phi(x) = [x, RBF(x)]: ``(..., n) -> (..., d)``."""
    return rbf_lift(X, model.centers, model.gamma, model.rbf_weights)


@full_f32()
def decode(model: KoopmanModel, Z):
    """Read lifted states back into state space."""
    if model.decoder is not None:
        return Z @ model.decoder.T
    return Z[..., : model.state_dim]


def _position_mask(X):
    w = torch.ones(X.shape[-1], dtype=X.dtype, device=X.device)
    w[:3] = 0.0
    return w


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

@full_f32()
def _solve_normal_eqns(gram, rhs, ridge):
    """Tikhonov-regularised normal-equation solve ``(gram + ridge I)^-1
    rhs``, the one solve of the batch fit and the streaming accumulator.
    Batched over leading dimensions (``ridge`` broadcasts over them); a
    matrix whose Cholesky factorisation fails gives NaN."""
    ridge = torch.as_tensor(ridge, dtype=gram.dtype, device=gram.device)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    L, info = torch.linalg.cholesky_ex(gram + ridge[..., None, None] * eye)
    M = torch.cholesky_solve(rhs, L)
    return torch.where((info > 0)[..., None, None], torch.full_like(M, float("nan")), M)


def _gram(G, Y):
    """The normal equations' ``(G^T G, G^T Y)``, accumulated in float64."""
    G = G.to(torch.float64)
    return G.T @ G, G.T @ Y.to(torch.float64)


def _ridge_solve(G, Y, ridge):
    """Solve ``min ||G M - Y||^2 + ridge ||M||^2`` for ``M`` (in ``G``'s
    dtype; the normal equations are formed and solved in float64), in the
    span ``brov2.koopman.normal_eqns``."""
    with span("brov2.koopman.normal_eqns"):
        return _solve_normal_eqns(*_gram(G, Y), ridge).to(G.dtype)


def _fit_from_blocks(Z, Zp, Uc, centers, gamma, ridge):
    G = torch.cat([Z, Uc], dim=1)
    M = _ridge_solve(G, Zp, ridge)
    d = Z.shape[1]
    return KoopmanModel(centers=centers, gamma=torch.as_tensor(gamma, dtype=Z.dtype,
                                                               device=Z.device),
                        A=M[:d].T, B=M[d:].T)


def fit(
    generator: Optional[torch.Generator],
    X,
    U,
    n_rbfs: int = 200,
    gamma: float = 1.0,
    ridge: float = 1e-8,
    kmeans_iters: int = 25,
    position_invariant: bool = False,
    init=None,
) -> KoopmanModel:
    """Fit (A, B) from one trajectory: states ``X (N, n)``, inputs ``U (N, r)``.

    k-means centers on the state cloud (seeded from ``generator``, or
    Lloyd rounds from ``init``), the lifted consecutive snapshot pairs (the
    span ``brov2.koopman.lift``), one ridge normal-equation solve.
    ``position_invariant`` masks x, y, z out of the RBF distances.
    """
    weights = _position_mask(X) if position_invariant else None
    X_cl = X * weights if weights is not None else X
    centers, _ = kmeans(X_cl, n_rbfs, kmeans_iters, generator, init)
    gamma = torch.as_tensor(gamma, dtype=X.dtype, device=X.device)
    with span("brov2.koopman.lift"):
        Z = rbf_lift(X[:-1], centers, gamma, weights)
        Zp = rbf_lift(X[1:], centers, gamma, weights)
    return _fit_from_blocks(Z, Zp, U[:-1], centers, gamma, ridge)._replace(rbf_weights=weights)


def fit_multi(
    generator: Optional[torch.Generator],
    X_list: Sequence,
    U_list: Sequence,
    n_rbfs: int = 200,
    gamma: float = 1.0,
    ridge: float = 1e-8,
    kmeans_iters: int = 25,
    position_invariant: bool = False,
    init=None,
) -> KoopmanModel:
    """Fit from several independent trajectories without cross-trajectory
    pairs: centers on the union of all states, snapshot pairs built a
    trajectory at a time and stacked."""
    if len(X_list) != len(U_list) or not X_list:
        raise ValueError(
            f"X_list ({len(X_list)}) and U_list ({len(U_list)}) must be "
            "equal-length and non-empty")
    X_all = torch.cat([X for X in X_list if len(X) > 0], dim=0)
    weights = _position_mask(X_all) if position_invariant else None
    if weights is not None:
        X_all = X_all * weights
    centers, _ = kmeans(X_all, n_rbfs, kmeans_iters, generator, init)
    gamma = torch.as_tensor(gamma, dtype=X_all.dtype, device=X_all.device)
    Z_blocks, Zp_blocks, U_blocks = [], [], []
    for X, U in zip(X_list, U_list):
        if X.shape[0] < 2:
            continue
        Z_blocks.append(rbf_lift(X[:-1], centers, gamma, weights))
        Zp_blocks.append(rbf_lift(X[1:], centers, gamma, weights))
        U_blocks.append(U[:-1])
    model = _fit_from_blocks(torch.cat(Z_blocks), torch.cat(Zp_blocks), torch.cat(U_blocks),
                             centers, gamma, ridge)
    return model._replace(rbf_weights=weights)


@full_f32()
def fit_decoder(model: KoopmanModel, X, ridge: float = 1e-6) -> KoopmanModel:
    """Learn a linear decoder ``x ~ W z``.  ``ridge`` is relative to the
    mean Gram diagonal: the RBF features are highly correlated, so an
    absolute ridge can leave the float32 Cholesky of ``Z^T Z`` failing and
    the decoder NaN."""
    Z = lift(model, X)
    scale = torch.mean(torch.sum(Z * Z, dim=0))
    W = _ridge_solve(Z, X, ridge * scale)   # (d, n)
    return model._replace(decoder=W.T)


# ---------------------------------------------------------------------------
# Streaming / recursive fit
# ---------------------------------------------------------------------------
#
# The ridge solution depends on the data only through gram = G^T G and
# rhs = G^T Z+, which accumulate over chunks as two GEMMs a chunk.  A
# forgetting factor lam weights each pair by lam^age (recursive least
# squares).  With lam = 1 and the same pairs, streaming_finalize is the
# batch fit's solve.  Centers stay fixed; only (A, B) adapt.


class KoopmanStats(NamedTuple):
    """Sufficient statistics of the EDMDc ridge solve, accumulated online.

    ``prev_z``/``prev_u``/``prev_valid`` carry the last lifted sample
    across chunk boundaries, so any chunking of a contiguous recording
    gives the batch fit's pairs.  ``weight_sum`` is the effective number of
    pairs (the sum of the forgetting weights).
    """

    centers: torch.Tensor             # (k, n)
    gamma: torch.Tensor               # scalar
    gram: torch.Tensor                # (d+r, d+r)
    rhs: torch.Tensor                 # (d+r, d)
    weight_sum: torch.Tensor          # scalar
    prev_z: torch.Tensor              # (d,)
    prev_u: torch.Tensor              # (r,)
    prev_valid: torch.Tensor          # scalar 0/1
    rbf_weights: Optional[torch.Tensor] = None

    @property
    def state_dim(self) -> int:
        return self.centers.shape[1]

    @property
    def lift_dim(self) -> int:
        return self.rhs.shape[1]

    @property
    def input_dim(self) -> int:
        return self.rhs.shape[0] - self.rhs.shape[1]


def streaming_init(centers, gamma, input_dim: int, rbf_weights=None,
                   dtype=torch.float32, device=None) -> KoopmanStats:
    """Empty accumulator for a fixed dictionary on ``device`` (``None``
    means ``cuda``)."""
    device = resolve_device(device)
    centers = torch.as_tensor(centers, dtype=dtype, device=device)
    k, n = centers.shape
    d = n + k
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return KoopmanStats(
        centers=centers,
        gamma=torch.as_tensor(gamma, dtype=dtype, device=device),
        gram=z(d + input_dim, d + input_dim),
        rhs=z(d + input_dim, d),
        weight_sum=z(),
        prev_z=z(d),
        prev_u=z(input_dim),
        prev_valid=z(),
        rbf_weights=(None if rbf_weights is None
                     else torch.as_tensor(rbf_weights, dtype=dtype, device=device)),
    )


@full_f32()
def streaming_update(stats: KoopmanStats, X, U, forgetting=1.0) -> KoopmanStats:
    """Absorb a contiguous chunk ``X (N, n)``, ``U (N, r)``: its N-1
    internal pairs plus, after an earlier chunk, the boundary pair. With
    ``forgetting < 1`` what was absorbed decays by ``forgetting^m`` (m =
    pairs added here) and the new pairs enter with ``forgetting^age``."""
    dtype, device = stats.gram.dtype, stats.gram.device
    X = torch.as_tensor(X, dtype=dtype, device=device)
    U = torch.as_tensor(U, dtype=dtype, device=device)
    N = X.shape[0]
    if N == 0:
        return stats
    lam = torch.as_tensor(forgetting, dtype=dtype, device=device)
    Z_all = rbf_lift(X, stats.centers, stats.gamma, stats.rbf_weights)
    # row 0: the boundary pair (prev -> X[0]); rows 1..: the internal pairs
    G = torch.cat([
        torch.cat([stats.prev_z, stats.prev_u])[None],
        torch.cat([Z_all[:-1], U[:-1]], dim=1),
    ], dim=0)
    ages = torch.arange(N - 1, -1, -1, dtype=dtype, device=device)
    valid = torch.cat([stats.prev_valid[None], torch.ones(N - 1, dtype=dtype, device=device)])
    w = valid * lam ** ages
    sw = torch.sqrt(w)[:, None]
    Gw = G * sw
    Yw = Z_all * sw
    decay = lam ** ((N - 1) + stats.prev_valid)
    return stats._replace(
        gram=decay * stats.gram + Gw.T @ Gw,
        rhs=decay * stats.rhs + Gw.T @ Yw,
        weight_sum=decay * stats.weight_sum + torch.sum(w),
        prev_z=Z_all[-1],
        prev_u=U[-1],
        prev_valid=torch.ones((), dtype=dtype, device=device),
    )


def streaming_update_episode(stats: KoopmanStats, X, U, forgetting=1.0) -> KoopmanStats:
    """Absorb a self-contained episode: ``X (N+1, n)`` with both endpoints,
    ``U (N, r)`` the controls at ``X[:-1]``; exactly its N pairs, no
    boundary pair in or out."""
    if X.shape[0] != U.shape[0] + 1:
        raise ValueError(
            f"episode update expects X (N+1, n) and U (N, r); got "
            f"X {tuple(X.shape)} vs U {tuple(U.shape)}")
    dtype, device = stats.gram.dtype, stats.gram.device
    U = torch.as_tensor(U, dtype=dtype, device=device)
    U_pad = torch.cat([U, torch.zeros((1, U.shape[1]), dtype=dtype, device=device)])
    zero = torch.zeros((), dtype=dtype, device=device)
    stats = streaming_update(stats._replace(prev_valid=zero), X, U_pad, forgetting)
    return stats._replace(prev_valid=zero)


def streaming_scan(stats: KoopmanStats, X, U, chunk: int, forgetting=1.0) -> KoopmanStats:
    """Feed a long contiguous recording through :func:`streaming_update`
    in ``chunk``-row pieces (the trailing rows as one more update)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for lo in range(0, X.shape[0], chunk):
        stats = streaming_update(stats, X[lo:lo + chunk], U[lo:lo + chunk], forgetting)
    return stats


def streaming_finalize(stats: KoopmanStats, ridge=1e-8) -> KoopmanModel:
    """Solve the accumulated normal equations into a :class:`KoopmanModel`
    (``ridge`` acts against the decayed Gram)."""
    d = stats.lift_dim
    M = _solve_normal_eqns(stats.gram.to(torch.float64), stats.rhs.to(torch.float64),
                           ridge).to(stats.gram.dtype)
    return KoopmanModel(centers=stats.centers, gamma=stats.gamma, A=M[:d].T, B=M[d:].T,
                        rbf_weights=stats.rbf_weights)


def fit_streaming(
    generator: Optional[torch.Generator],
    X,
    U,
    n_rbfs: int = 200,
    gamma: float = 1.0,
    ridge: float = 1e-8,
    chunk: int = 1024,
    kmeans_iters: int = 25,
    position_invariant: bool = False,
    forgetting: float = 1.0,
    init=None,
) -> KoopmanModel:
    """:func:`fit` through the streaming accumulator: k-means centers on
    the whole state cloud, :func:`streaming_scan` in ``chunk``-row pieces
    into float64 statistics (as the batch fit forms its normal equations),
    one :func:`streaming_finalize`, the model rounded to ``X``'s dtype."""
    weights = _position_mask(X) if position_invariant else None
    X_cl = X * weights if weights is not None else X
    centers, _ = kmeans(X_cl, n_rbfs, kmeans_iters, generator, init)
    stats = streaming_init(centers, gamma, input_dim=U.shape[1], rbf_weights=weights,
                           dtype=torch.float64, device=X.device)
    stats = streaming_scan(stats, X, U, chunk, forgetting)
    model = streaming_finalize(stats, ridge)
    return KoopmanModel(*(None if f is None else f.to(X.dtype) for f in model))


# ---------------------------------------------------------------------------
# Persistence: the JAX package's .npz layout, so its saved models load here
# ---------------------------------------------------------------------------

def save_model(path, model: KoopmanModel) -> None:
    """Save a fitted model as a self-describing ``.npz`` (the optional
    fields only when present)."""
    arrays = {k: getattr(model, k).detach().cpu().numpy()
              for k in KoopmanModel._fields if getattr(model, k) is not None}
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path.write_bytes(buf.getvalue())


def load_model(path, dtype=torch.float32, device=None) -> KoopmanModel:
    """Load a model saved by :func:`save_model` (this package's or the JAX
    package's); ``device=None`` means ``cuda``."""
    device = resolve_device(device)
    with np.load(path) as z:
        return KoopmanModel(*(
            torch.as_tensor(np.array(z[k]), dtype=dtype, device=device) if k in z else None
            for k in KoopmanModel._fields))


# ---------------------------------------------------------------------------
# Scoring and simulation
# ---------------------------------------------------------------------------

def _nan(X):
    return torch.tensor(float("nan"), dtype=X.dtype, device=X.device)


@full_f32()
def evaluate(model: KoopmanModel, X, U):
    """One-step RMSE in state space."""
    Z = lift(model, X[:-1])
    Z_next = Z @ model.A.T + U[:-1] @ model.B.T
    return rmse(X[1:], decode(model, Z_next))


@full_f32()
def _matrix_power_T(A_T, H: int):
    """``A_T ** H`` by repeated squaring (H >= 1)."""
    result, base, h = None, A_T, H
    while h:
        if h & 1:
            result = base if result is None else result @ base
        h >>= 1
        if h:
            base = base @ base
    return result


@full_f32()
def _endpoint_conv(Z0, U, A_T, B_T, H: int, n_start: int, cols: slice = slice(None)):
    """The H-step endpoint of the affine lifted recurrence as one batched
    GEMM: ``z_H = z_0 A_T^H + sum_{j<H} u_j (B_T A_T^(H-1-j))``, the
    control windows ``(n_start, H r)`` against the stacked kernels ``(H r,
    d)``.  ``cols`` picks the endpoint's columns (a tensor-parallel
    rank's block)."""
    K, W = [], B_T
    for _ in range(H):
        K.append(W)
        W = W @ A_T
    K = torch.stack(K[::-1])                      # step j uses A_T^(H-1-j)
    U_win = torch.stack([U[j:j + n_start] for j in range(H)], dim=1)   # (n_start, H, r)
    P = _matrix_power_T(A_T, H)
    K = K[..., cols]
    return Z0 @ P[:, cols] + U_win.reshape(n_start, -1) @ K.reshape(-1, K.shape[-1])


@full_f32()
def multistep_rmse(model: KoopmanModel, X, U, H: int = 10,
                   post_decode: Optional[Callable] = None, method: str = "scan"):
    """Endpoint H-step RMSE over all N-H starts.

    All starts are lifted once and propagated together: ``"scan"`` takes H
    steps of GEMMs (step t reads ``U[t : t + n_start]``), ``"conv"`` the
    same endpoint as one control-convolution GEMM (:func:`_endpoint_conv`),
    either in the span ``brov2.koopman.propagate``.  ``H = 0`` scores the
    reconstruction; ``N <= H`` gives NaN.
    ``post_decode`` transforms the decoded predictions before scoring.
    """
    if method not in ("scan", "conv"):
        raise ValueError(f"method must be 'scan' or 'conv', got {method!r}")
    n_start = X.shape[0] - H
    if n_start <= 0:
        return _nan(X)
    Z = lift(model, X[:n_start])
    A_T, B_T = model.A.T, model.B.T
    if H > 0:
        with span("brov2.koopman.propagate"):
            if method == "conv":
                Z = _endpoint_conv(Z, U, A_T, B_T, H, n_start)
            else:
                for t in range(H):
                    Z = Z @ A_T + U[t:t + n_start] @ B_T
    pred = decode(model, Z)
    if post_decode is not None:
        pred = post_decode(pred)
    return rmse(X[H:], pred)


@full_f32()
def simulate(model: KoopmanModel, x0, U_seq):
    """Open-loop rollout from ``x0`` under ``U_seq (T, r)``: ``(T+1, n)``
    predictions with ``x0`` in row 0.  The lifted state propagates
    without re-lifting.  Batched ``x0 (B, n)`` with ``U_seq (T, B, r)``
    works too."""
    z = lift(model, x0)
    xs = [x0]
    for t in range(U_seq.shape[0]):
        z = z @ model.A.T + U_seq[t] @ model.B.T
        xs.append(decode(model, z))
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# Hyperparameter sweeps
# ---------------------------------------------------------------------------

@full_f32()
def fit_sweep(
    generator: Optional[torch.Generator],
    X,
    U,
    n_rbfs: int = 200,
    gammas=(0.5, 1.0, 3.0),
    ridges=(1e-6, 1e-3, 1e-1),
    kmeans_iters: int = 25,
    position_invariant: bool = False,
    init=None,
):
    """Fit every (gamma, ridge) combination: k-means once, one lift and one
    Gram a gamma, and the ridges' solves as one batched Cholesky.  Returns
    a :class:`KoopmanModel` whose leading axis indexes the ``len(gammas)
    * len(ridges)`` combinations (row-major), and the ``(combo, 2)``
    tensor of (gamma, ridge) pairs."""
    weights = _position_mask(X) if position_invariant else None
    X_cl = X * weights if weights is not None else X
    centers, _ = kmeans(X_cl, n_rbfs, kmeans_iters, generator, init)
    combos = torch.tensor([(g, r) for g in gammas for r in ridges], dtype=X.dtype,
                          device=X.device)
    R, d = len(ridges), X.shape[1] + n_rbfs
    A, B = [], []
    for gi in range(len(gammas)):
        rows = combos[gi * R:(gi + 1) * R]
        Z = rbf_lift(X[:-1], centers, rows[0, 0], weights)
        Zp = rbf_lift(X[1:], centers, rows[0, 0], weights)
        gram, rhs = _gram(torch.cat([Z, U[:-1]], dim=1), Zp)
        M = _solve_normal_eqns(gram.expand(R, *gram.shape), rhs.expand(R, *rhs.shape),
                               rows[:, 1]).to(X.dtype)
        A.append(M[:, :d].transpose(1, 2))
        B.append(M[:, d:].transpose(1, 2))
    C = combos.shape[0]
    models = KoopmanModel(
        centers=centers.expand(C, *centers.shape), gamma=combos[:, 0].clone(),
        A=torch.cat(A), B=torch.cat(B),
        rbf_weights=None if weights is None else weights.expand(C, *weights.shape))
    return models, combos


def select_best(models: KoopmanModel, combos, X_val, U_val, H: int = 10,
                method: str = "scan"):
    """Score every swept model by endpoint H-step RMSE on validation data;
    returns ``(best_model, best_combo, rmses)``.  NaN scores (a combo whose
    Cholesky failed) count as +inf, so one bad combo never poisons the
    argmin; every combo NaN raises."""
    pick = lambda c: KoopmanModel(*(None if f is None else f[c] for f in models))  # noqa: E731
    rmses = torch.stack([multistep_rmse(pick(c), X_val, U_val, H, method=method)
                         for c in range(combos.shape[0])])
    finite = torch.where(torch.isnan(rmses), torch.full_like(rmses, float("inf")), rmses)
    if not bool(torch.isfinite(finite).any()):
        raise RuntimeError(
            "every swept (gamma, ridge) combination produced a NaN model "
            "(ill-conditioned fits); increase the ridge values or reduce "
            "the dictionary size")
    best = int(torch.argmin(finite))
    return pick(best), combos[best], rmses

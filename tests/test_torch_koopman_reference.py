"""The port's Koopman EDMDc pieces (``ops/lifting.py``, ``ops/kmeans.py``,
``models/koopman.py``) against the benchmark's plain reference
(``portbench/reference/koopman.py``), which is written from the configuration
file and imports nothing of the port: the lift, the Lloyd rounds from given
centers, the ridge normal equations and the resulting A and B, and
``multistep_rmse`` by scan, at 2,048 rows, 32 RBFs and H = 1, 5, 20, on
seeded random states (a yaw wound to 20 rad, as the tank recording's is) and
a seeded random model.  CPU only, no JAX.

Tolerances (the largest of six seeds in brackets):
- float64 (the port in float64 against the reference): 1e-12 for each
  [8.2e-16; the same operations in the same order read 0].
- float32 (the port as it runs, against the float64 reference): the lift
  at 5e-5 of its largest entry [8.4e-6: the Gram-expansion distance errs
  by ~eps |x|^2 with |x|^2 up to ~400, and gamma = 3 carries that into the
  features]; the Lloyd rounds at 2e-6 of max(1, |c|) [3.3e-7: no row of
  these states lies within rounding of a tie, so no assignment flips]; [A
  B] at 1e-3 of its largest entry [1.4e-4: the lift's error through normal
  equations with ridge 0.1]; the endpoint RMSE of the random model at rtol
  1e-6 [8.4e-8], of the model fitted to these rows at H = 20 at rtol 2e-6
  [5.9e-7: A's eigenvalues near 1 carry the rounding across the steps].
- TF32-rounded propagation (each GEMM's operands and result at a 10-bit
  mantissa) of that fitted model reads 2.8e-4 to 5.5e-3 from float64 at
  H = 20 [3.8e-3 on this file's seed], past the float32 tolerance.
"""

import json
from pathlib import Path

import pytest
import torch

from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
from bluerov2_dynamics_tpu_torch.models import koopman
from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift
from portbench.reference import koopman as rk
from portbench.reference.fossen import round_tf32

ROOT = Path(__file__).resolve().parents[1]
F64, F32 = torch.float64, torch.float32
N, K = 2048, 32
TOL = {F64: dict(lift=1e-12, lloyd=1e-12, ab=1e-12, rmse=1e-12),
       F32: dict(lift=5e-5, lloyd=2e-6, ab=1e-3, rmse=1e-6)}
FITTED_F32_RTOL = 2e-6          # the fitted model's float32 RMSE at H = 20


def _cfg() -> dict:
    cfg = json.loads((ROOT / "portbench/configs/bluerov2-heavy-koopman.json").read_text())
    cfg["koopman"].update(n_rbfs=K, lift_dim=12 + K, gram_width=20 + K)
    return cfg


CFG = _cfg()


@pytest.fixture(scope="module")
def case():
    """Seeded states and commands, initial centers drawn among the rows, and a
    random model (A at spectral norm 0.97)."""
    g = torch.Generator().manual_seed(22)
    scale = torch.tensor([2, 2, 1, .1, .1, 1, .2, .2, .2, .1, .1, .1], dtype=F64)
    X = torch.randn(N, 12, generator=g, dtype=F64) * scale
    X[:, 5] += torch.linspace(0, 20, N, dtype=F64)
    U = 2 * torch.rand(N, 8, generator=g, dtype=F64) - 1
    C = X[torch.randperm(N, generator=g)[:K]].clone()
    d = 12 + K
    A = torch.randn(d, d, generator=g, dtype=F64)
    A = 0.97 * A / torch.linalg.matrix_norm(A, 2)
    B = 0.1 * torch.randn(d, 8, generator=g, dtype=F64)
    return dict(X=X, U=U, C=C, model=rk.Model(C, A, B))


def _port_model(model: rk.Model, dtype) -> koopman.KoopmanModel:
    gamma = torch.tensor(CFG["koopman"]["gamma"], dtype=dtype)
    return koopman.KoopmanModel(model.centers.to(dtype), gamma, model.A.to(dtype),
                                model.B.to(dtype))


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [F64, F32])
def test_lift(case, dtype):
    X, C = case["X"], case["C"]
    got = rbf_lift(X.to(dtype), C.to(dtype), torch.tensor(3.0, dtype=dtype))
    assert _rel(got, rk.lift(CFG, X, C)) < TOL[dtype]["lift"]


@pytest.mark.parametrize("dtype", [F64, F32])
def test_lloyd_rounds_from_given_centers(case, dtype):
    X, C = case["X"], case["C"]
    got = kmeans(X.to(dtype), K, CFG["koopman"]["kmeans_iters"], None, C.to(dtype))[0].double()
    want = rk.lloyd(CFG, X, C)
    assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) < TOL[dtype]["lloyd"]
    # the rounds moved the centers far beyond the tolerance
    assert float((want - C).abs().max()) > 0.1


@pytest.mark.parametrize("dtype", [F64, F32])
def test_normal_equations_give_a_and_b(case, dtype):
    X, U, C = case["X"], case["U"], case["C"]
    k = CFG["koopman"]
    m = koopman.fit(None, X.to(dtype), U.to(dtype), n_rbfs=K, gamma=k["gamma"],
                    ridge=k["ridge"], kmeans_iters=0, init=C.to(dtype))
    assert torch.equal(m.centers, C.to(dtype))
    want = rk.normal_equations(CFG, X, U, C)
    assert m.A.shape == (12 + K, 12 + K) and m.B.shape == (12 + K, 8)
    M_ref = torch.cat([want.A, want.B], 1)
    assert _rel(torch.cat([m.A, m.B], 1), M_ref) < TOL[dtype]["ab"]


@pytest.mark.parametrize("H", [1, 5, 20])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_multistep_rmse_by_scan(case, dtype, H):
    X, U = case["X"], case["U"]
    got = float(koopman.multistep_rmse(_port_model(case["model"], dtype), X.to(dtype),
                                       U.to(dtype), H, method="scan"))
    want = rk.endpoint_rmse(CFG, case["model"], X, U, H)
    assert got == pytest.approx(want, rel=TOL[dtype]["rmse"], abs=0)


def _tf32_scan(model: koopman.KoopmanModel, X, U, H: int):
    """``multistep_rmse``'s scan with each GEMM's operands and result rounded
    to TF32."""
    n_start = X.shape[0] - H
    Z = koopman.lift(model, X[:n_start])
    r = round_tf32
    for t in range(H):
        Z = r(r(Z) @ r(model.A.T)) + r(r(U[t:t + n_start]) @ r(model.B.T))
    return rmse(X[H:], Z[:, :model.state_dim])


def test_tf32_propagation_breaks_the_float32_tolerance(case):
    X, U, C = case["X"], case["U"], case["C"]
    fitted = rk.normal_equations(CFG, X, U, C)
    want = rk.endpoint_rmse(CFG, fitted, X, U, 20)
    model = _port_model(fitted, F32)
    f32 = float(koopman.multistep_rmse(model, X.float(), U.float(), 20, method="scan"))
    tf32 = float(_tf32_scan(model, X.float(), U.float(), 20))
    assert f32 == pytest.approx(want, rel=FITTED_F32_RTOL, abs=0)
    assert abs(tf32 - want) / want > FITTED_F32_RTOL

"""The sysid lag history (``models/sysid.py::lag_history``): its kernel
``csrc/lag_history.cu`` on the card and its plain version
``thrusters.lag_history_chunked``, each against the serial loop the history
was before, in float64, and against the JAX package's ``lax.scan``
(float64, on the CPU).

The CPU cases hold the chunked plain version at ragged lengths around the
kernel's 256-row chunks, and against JAX across one and sixteen chunk
carries; the card cases (``cuda`` marker) hold the kernel there and at a
tank recording's 36,658-row training split.  Tolerances: float32 within
1e-5 of the history's largest magnitude, float64 within 1e-12 of it,
against the float64 serial loop on the host CPU and against JAX (the
reassociated scan differs from the serial one by rounding alone: the lag is
contractive); the kernel against the plain version on the same card within
2e-6 (float32) and 1e-13 (float64) of the largest magnitude, the same bits
on ten calls.
"""

import functools
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu.models import sysid as jsysid
from bluerov2_dynamics_tpu.models.params import lag_params as jlag_params
from bluerov2_dynamics_tpu.models.params import thruster_config as jthruster_config
from bluerov2_dynamics_tpu_torch.models import sysid
from bluerov2_dynamics_tpu_torch.models.params import lag_params, thruster_config
from bluerov2_dynamics_tpu_torch.models.thrusters import lag_history_chunked, static_thrust
from bluerov2_dynamics_tpu_torch.ops import _build

DT = 0.02
LENGTHS = (0, 1, 7, 255, 256, 257, 4_097)
TRAIN_ROWS = 36_658                  # a tank recording's training split
JAX_LENGTHS = (257, 4_097)           # one chunk carry, sixteen
DTYPES = {"float32": torch.float32, "float64": torch.float64}
TOL = {"float32": 1e-5, "float64": 1e-12}              # against float64 (serial loop, JAX)
PLAIN_TOL = {"float32": 2e-6, "float64": 1e-13}        # kernel against plain, one card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lag-history kernel has no CPU mode")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _commands(n: int, seed: int = 5) -> np.ndarray:
    """Smooth random thruster commands ``(n, 8)`` in [-1, 1] (float64)."""
    rng = np.random.default_rng(seed)
    U, u = np.empty((n, 8)), np.zeros(8)
    for k in range(n):
        u = np.clip(0.95 * u + 0.3 * rng.normal(size=8), -1.0, 1.0)
        U[k] = u
    return U


def _inputs(n: int, dtype, device):
    """``(cfg, lag, U)`` in ``dtype`` on ``device``."""
    return (thruster_config(dtype=dtype, device=device), lag_params(DT, dtype=dtype, device=device),
            torch.as_tensor(_commands(n), dtype=dtype, device=device))


def serial_history(lag, F_cmd):
    """The serial loop: ``L <- L Ad^T + F[k] Bd`` a row, the state before
    each row kept (the history's first form, and its reference)."""
    L = F_cmd.new_zeros((8, 3))
    AdT = lag.Ad.T
    hist = []
    for k in range(F_cmd.shape[0]):
        hist.append(L)
        L = L @ AdT + F_cmd[k][..., None] * lag.Bd
    return torch.stack(hist) if hist else L.new_zeros((0, 8, 3))


@functools.lru_cache(maxsize=None)
def _reference(n: int) -> torch.Tensor:
    """The serial loop in float64 on the host CPU."""
    cfg, lag, U = _inputs(n, torch.float64, "cpu")
    return serial_history(lag, static_thrust(cfg, U))


@functools.lru_cache(maxsize=None)
def _jax_reference(n: int) -> torch.Tensor:
    """The JAX package's ``lag_history`` in float64 on the CPU."""
    want = jsysid.lag_history(jthruster_config(dtype=jnp.float64),
                              jlag_params(DT, dtype=jnp.float64), jnp.asarray(_commands(n)))
    return torch.from_numpy(np.array(want, np.float64))


def _gap(got, want) -> float:
    """``max |got - want|`` over the largest ``|want|`` (0 where both are
    zero: an empty or one-row history)."""
    if got.numel() == 0:
        return 0.0
    diff = float((got.double().cpu() - want).abs().max())
    return diff / float(want.abs().max()) if diff else 0.0


def _check_contract(hist, n, dtype):
    assert hist.shape == (n, 8, 3) and hist.dtype == dtype
    if n:
        assert torch.count_nonzero(hist[0]) == 0


# --- the plain version on the CPU ----------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
def test_chunked_matches_the_serial_loop(n, dtype):
    cfg, lag, U = _inputs(n, DTYPES[dtype], "cpu")
    got = lag_history_chunked(lag, static_thrust(cfg, U))
    _check_contract(got, n, DTYPES[dtype])
    assert _gap(got, _reference(n)) <= TOL[dtype]


@pytest.mark.parametrize("chunk, lanes", [(16, 4), (64, 64), (8, 8)])
def test_chunked_holds_for_other_chunks_and_lanes(chunk, lanes):
    cfg, lag, U = _inputs(257, torch.float64, "cpu")
    got = lag_history_chunked(lag, static_thrust(cfg, U), chunk=chunk, lanes=lanes)
    assert _gap(got, _reference(257)) <= TOL["float64"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", JAX_LENGTHS)
def test_lag_history_on_the_cpu_matches_jax_across_chunk_carries(n, dtype):
    got = sysid.lag_history(*_inputs(n, DTYPES[dtype], "cpu"))
    _check_contract(got, n, DTYPES[dtype])
    assert _gap(got, _jax_reference(n)) <= TOL[dtype]


def test_the_plain_chunk_mirrors_the_kernel_constants():
    text = (Path(sysid.__file__).resolve().parent.parent / "csrc" / "lag_history.cu").read_text()
    const = {m.group(1): m.group(2) for m in re.finditer(r"constexpr \w+ (k\w+) = ([^;]+);", text)}
    defaults = inspect.signature(lag_history_chunked).parameters
    assert int(const["kChunk"]) == defaults["chunk"].default
    assert int(const["kLanes"]) == defaults["lanes"].default


def test_lag_history_on_the_cpu_is_the_chunked_version_and_launches_nothing():
    cfg, lag, U = _inputs(300, torch.float32, "cpu")
    before = dict(_build.launches)
    got = sysid.lag_history(cfg, lag, U)
    assert _build.launches == before
    assert torch.equal(got, lag_history_chunked(lag, static_thrust(cfg, U)))


@pytest.mark.parametrize("fault", ["cpu", "float16", "lag_dtype", "lag_device", "shape",
                                   "strided"])
def test_the_launcher_refuses_what_the_kernel_does_not_take(fault):
    """The launcher checks type, shape, contiguity and device before any
    build, in that order, so its refusals hold on CPU tensors."""
    cfg, lag, U = _inputs(20, torch.float32, "cpu")
    F = static_thrust(cfg, U)
    cases = {
        "cpu": (ValueError, "F_cmd must be a CUDA tensor", F, lag),
        "float16": (TypeError, "float32 or float64", F.half(), lag),
        "lag_dtype": (TypeError, "Ad must be torch.float32", F, lag._replace(Ad=lag.Ad.double())),
        "lag_device": (ValueError, "Bd must be on cpu", F, lag._replace(Bd=lag.Bd.to("meta"))),
        "shape": (ValueError, "F_cmd must have shape", F[:, :6], lag),
        "strided": (ValueError, "F_cmd must be contiguous", torch.empty((20, 16))[:, ::2], lag),
    }
    err, match, F_cmd, lag_in = cases[fault]
    with pytest.raises(err, match=match):
        sysid._launch_lag_history(lag_in, F_cmd)


# --- the kernel on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", LENGTHS + (TRAIN_ROWS,))
def test_kernel_matches_the_serial_float64_loop(n, dtype, cuda):
    cfg, lag, U = _inputs(n, DTYPES[dtype], cuda)
    before = _build.launches["lag_history"]
    got = sysid.lag_history(cfg, lag, U)
    torch.cuda.synchronize()
    assert _build.launches["lag_history"] == before + 1
    _check_contract(got, n, DTYPES[dtype])
    gap = _gap(got, _reference(n))
    ccfg, clag, cU = _inputs(n, DTYPES[dtype], "cpu")
    serial_gap = _gap(serial_history(clag, static_thrust(ccfg, cU)), _reference(n))
    print(f"lag_history N={n} {dtype}: kernel {gap:.3e}, serial loop {serial_gap:.3e} of the "
          f"largest magnitude off the float64 serial loop")
    assert gap <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", JAX_LENGTHS + (TRAIN_ROWS,))
def test_kernel_matches_jax(n, dtype, cuda):
    got = sysid.lag_history(*_inputs(n, DTYPES[dtype], cuda))
    _check_contract(got, n, DTYPES[dtype])
    gap = _gap(got, _jax_reference(n))
    print(f"lag_history N={n} {dtype}: kernel {gap:.3e} of the largest magnitude off JAX's "
          f"float64 lax.scan")
    assert gap <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", JAX_LENGTHS + (TRAIN_ROWS,))
def test_kernel_matches_its_plain_version_on_the_card(n, dtype, cuda):
    cfg, lag, U = _inputs(n, DTYPES[dtype], cuda)
    F = static_thrust(cfg, U)
    got = sysid._launch_lag_history(lag, F)
    want = lag_history_chunked(lag, F)
    gap = _gap(got, want.double().cpu())
    print(f"lag_history N={n} {dtype}: kernel against its plain version {gap:.3e}")
    assert gap <= PLAIN_TOL[dtype]


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_on_ten_calls(cuda):
    cfg, lag, U = _inputs(TRAIN_ROWS, torch.float32, cuda)
    calls = {sysid.lag_history(cfg, lag, U).cpu().numpy().tobytes() for _ in range(10)}
    assert len(calls) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("lag_warmup", [True, False])
def test_a_card_fit_launches_the_kernel_once_with_lag_warm_up(lag_warmup, cuda):
    from bluerov2_dynamics_tpu_torch.data import synthetic

    rec = synthetic.generate_tank_recording(3, n_steps=600, device="cpu")
    X, U = rec.X.float().to(cuda), rec.U.float().to(cuda)
    before = _build.launches["lag_history"]
    sysid.fit_thruster(X, U, DT, horizon=10, steps=3, lr=0.02, lag_warmup=lag_warmup)
    torch.cuda.synchronize()
    assert _build.launches["lag_history"] == before + int(lag_warmup)

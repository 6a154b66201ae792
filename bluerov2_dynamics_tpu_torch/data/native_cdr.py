"""ctypes binding for the native batch CDR decoders (host C++, not a kernel).

Counterpart of ``bluerov2_dynamics_tpu/data/native_cdr.py``.  The port's
own copy of the decoders, ``native/cdr_decode.cpp``, is compiled on first
use with the system ``g++`` into ``build/native_cdr/`` of the checkout,
named by a hash of the source and flags (as :mod:`..ops._build` names the
kernels), so an edited source rebuilds and nothing is ever written next to
the source.  The batch decoders take lists of message blobs.  A failed
build raises :class:`NativeUnavailable`; callers that can (``bag_sqlite``)
then use the per-message Python decoders in :mod:`.cdr`.

Parity with the Python decoders is tested in ``tests/test_torch_cdr.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "cdr_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_cdr"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join((CXX,) + CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcdrdecode-{h[:16]}.so"


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"could not build cdr_decode: {detail}") from e
    os.replace(tmp, lib)  # atomic: a concurrent process sees the whole library or none
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.decode_odometry_batch.restype = ctypes.c_int64
    lib.decode_odometry_batch.argtypes = [u8p, i64p, ctypes.c_int64, f64p, i8p]
    lib.decode_actuator_motors_batch.restype = ctypes.c_int64
    lib.decode_actuator_motors_batch.argtypes = [u8p, i64p, ctypes.c_int64, f32p]
    lib.decode_vehicle_odometry_batch.restype = ctypes.c_int64
    lib.decode_vehicle_odometry_batch.argtypes = [u8p, i64p, ctypes.c_int64, f32p]
    _lib = lib
    return lib


def _pack(blobs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    data = np.frombuffer(b"".join(blobs), np.uint8)
    return data, offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_odometry_batch(blobs: List[bytes]):
    """-> ``(fields (N, 13) float64, body_flags (N,) int8)``.

    Field columns: pos(3), quat xyzw(4), linear twist(3), angular twist(3).
    Raises ValueError if any blob is malformed.
    """
    lib = _load()
    data, offsets = _pack(blobs)
    n = len(blobs)
    out = np.empty((n, 13), np.float64)
    flags = np.zeros(n, np.int8)
    done = lib.decode_odometry_batch(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), n,
        _ptr(out, ctypes.c_double), _ptr(flags, ctypes.c_int8),
    )
    if done != n:
        raise ValueError(f"malformed Odometry blob at index {done}")
    return out, flags


def decode_actuator_motors_batch(blobs: List[bytes]) -> np.ndarray:
    """-> ``(N, 8) float32`` of the first eight control channels."""
    lib = _load()
    data, offsets = _pack(blobs)
    n = len(blobs)
    out = np.empty((n, 8), np.float32)
    done = lib.decode_actuator_motors_batch(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), n,
        _ptr(out, ctypes.c_float),
    )
    if done != n:
        raise ValueError(f"malformed ActuatorMotors blob at index {done}")
    return out


def decode_vehicle_odometry_batch(blobs: List[bytes]) -> np.ndarray:
    """-> ``(N, 13) float32``: pos(3), q wxyz(4), velocity(3), angvel(3)."""
    lib = _load()
    data, offsets = _pack(blobs)
    n = len(blobs)
    out = np.empty((n, 13), np.float32)
    done = lib.decode_vehicle_odometry_batch(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), n,
        _ptr(out, ctypes.c_float),
    )
    if done != n:
        raise ValueError(f"malformed VehicleOdometry blob at index {done}")
    return out


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False

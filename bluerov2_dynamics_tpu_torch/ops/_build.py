"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers), loaded with ``ctypes``.  A
library is built on its first use into ``build/torch_kernels/`` of the
checkout, named by a hash of its sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  :func:`build` starts one
``nvcc`` per source, all together.  A failed build raises; nothing falls
back to the plain PyTorch versions.

``launches`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (argtypes, restype)
_SIGNATURES = {
    "rollout": {
        "brov2_tau_seq": ([_P, _P, _P, _P, _I, _I, _P], _I),
        "brov2_rollout_final": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "brov2_error_string": ([_I], ctypes.c_char_p),
    },
    "window_eval": {
        "brov2_window_eval": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "brov2_batched_rollout": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "brov2_window_eval_wrench": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "brov2_error_string": ([_I], ctypes.c_char_p),
    },
    "quat": {
        "brov2_window_eval_quat": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "brov2_rollout_final_quat": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "brov2_error_string": ([_I], ctypes.c_char_p),
    },
    "probes": {
        "brov2_probe_fma": ([_P, _P, _I, _I, _I, _P], _I),
        "brov2_probe_sin": ([_P, _P, _I, _I, _I, _P], _I),
        "brov2_probe_fma_tree": ([_P, _P, _I, _I, _I, _P], _I),
        "brov2_probe_quat_mix": ([_P, _P, _I, _I, _I, _I, _P], _I),
        "brov2_error_string": ([_I], ctypes.c_char_p),
    },
}
SOURCES = tuple(_SIGNATURES)

launches = {"shared_tau": 0, "rollout_final": 0, "window_eval": 0, "batched_rollout": 0,
            "window_eval_wrench": 0, "window_eval_quat": 0, "rollout_final_quat": 0,
            "fma_peak": 0, "transcendental_peak": 0, "fma_tree_peak": 0, "quat_mix_peak": 0}
_libs: dict = {}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled with the CUDA "
            "toolkit on their first launch")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns ``{name: log}``
    with the compiler's output (register and spill report) of each."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in logs:
            log = library_path(name).with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.brov2_error_string(rc).decode()})")

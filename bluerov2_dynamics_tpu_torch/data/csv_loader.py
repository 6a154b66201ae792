"""CSV dataset loaders with the reference column contracts (host numpy).

Counterpart of ``bluerov2_dynamics_tpu/data/csv_loader.py``.  Three
contracts share one cleaning pipeline (sort by t, de-duplicate timestamps,
drop inf/NaN state rows, zero-fill missing input columns, median dt):

* thruster:   state ``x..r`` (12) + inputs ``u1..u8``;
* wrench:     state ``x..r`` (12) + inputs ``Fx..Mz``;
* quaternion: state ``x,y,z,qw..qz,u..r`` (13) + inputs ``Fx..Mz``, with
  legacy Euler CSVs converted to quaternions and every quaternion
  renormalised.

A CSV is read with numpy and the standard library (:mod:`.table`), with
pandas' parser and cleaning semantics reproduced, so the arrays equal the
JAX package's bit for bit and the loaders run where pandas is absent.
``pandas`` is imported only to read a ``.parquet`` file.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple

import numpy as np

from bluerov2_dynamics_tpu_torch.data import table as tb
from bluerov2_dynamics_tpu_torch.utils.log import info, warn

EULER12_COLS = ["x", "y", "z", "phi", "theta", "psi", "u", "v", "w", "p", "q", "r"]
QUAT13_COLS = ["x", "y", "z", "qw", "qx", "qy", "qz", "u", "v", "w", "p", "q", "r"]
THRUSTER_COLS = [f"u{i}" for i in range(1, 9)]
WRENCH_COLS = ["Fx", "Fy", "Fz", "Mx", "My", "Mz"]


class Dataset(NamedTuple):
    X: np.ndarray   # (N, n) states
    U: np.ndarray   # (N, r) inputs
    t: np.ndarray   # (N,) time stamps
    dt: float       # median sample period


def find_project_root(start: Path, marker: str = "rosbags") -> Path:
    """Walk up from ``start`` to the first directory containing ``marker``."""
    p = Path(start).resolve()
    for q in [p, *p.parents]:
        if (q / marker).exists():
            return q
    return p


def find_latest_csv(root: Path, name: str) -> Path:
    """Newest-mtime file called ``name`` under ``root``."""
    cands = sorted(
        Path(root).rglob(name), key=lambda p: p.stat().st_mtime, reverse=True
    )
    if not cands:
        raise FileNotFoundError(f"Could not find any '{name}' under: {root}")
    return cands[0]


def _clean_and_extract(
    df: tb.Table, state_cols: List[str], input_cols: List[str], verbose: bool
) -> Dataset:
    """The shared cleaning pipeline on a table, pandas' steps in order:
    sort by ``t`` (``sort_values``), keep each time's first row
    (``drop_duplicates``), inf to NaN in every numeric column, drop the
    rows with a NaN state (``dropna``)."""
    df = dict(df)
    for c in state_cols:
        if c not in df:
            raise ValueError(f"Missing state column: {c}")
    for c in input_cols:
        if c not in df:
            df[c] = np.zeros(tb.nrows(df))
    if "t" not in df:
        raise ValueError("CSV must contain a 't' time column.")
    df = tb.sort_by(df, "t")
    df = tb.take(df, tb.first_unique(df["t"]))
    df = {k: (np.where(np.isinf(v), np.nan, v) if v.dtype != object else v)
          for k, v in df.items()}
    df = tb.dropna(df, subset=state_cols)

    as_float = lambda cols: np.stack(  # noqa: E731
        [np.asarray(df[c], np.float64) for c in cols], axis=1).reshape(tb.nrows(df), len(cols))
    X = as_float(state_cols)
    U = as_float(input_cols)
    t = np.array(df["t"], np.float64)
    dt = float(np.median(np.diff(t))) if len(t) > 1 else 0.05
    if verbose:
        info(
            f"Samples: {len(t)} | median dt ≈ {dt:.5f}s"
            f" (~{1.0 / max(dt, 1e-9):.2f} Hz)"
        )
    return Dataset(X=X, U=U, t=t, dt=dt)


def _read(csv_path, verbose: bool) -> tb.Table:
    if verbose:
        info(f"Loading: {csv_path}")
    if str(csv_path).endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(csv_path)
        return {c: df[c].to_numpy(np.float64) if pd.api.types.is_numeric_dtype(df[c])
                else df[c].to_numpy(object) for c in df.columns}
    return tb.read_csv(csv_path)


def load_thruster_dataset(csv_path, verbose: bool = True) -> Dataset:
    """12-state + u1..u8 contract."""
    return _clean_and_extract(_read(csv_path, verbose), EULER12_COLS, THRUSTER_COLS, verbose)


def load_wrench_dataset(csv_path, verbose: bool = True) -> Dataset:
    """12-state + Fx..Mz contract."""
    return _clean_and_extract(_read(csv_path, verbose), EULER12_COLS, WRENCH_COLS, verbose)


def euler_to_quat_np(phi, theta, psi) -> np.ndarray:
    """Vectorised Z-Y-X Euler -> unit quaternion ``(..., 4)``, scalar first."""
    c1, s1 = np.cos(phi * 0.5), np.sin(phi * 0.5)
    c2, s2 = np.cos(theta * 0.5), np.sin(theta * 0.5)
    c3, s3 = np.cos(psi * 0.5), np.sin(psi * 0.5)
    q = np.stack(
        [
            c3 * c2 * c1 + s3 * s2 * s1,
            c3 * c2 * s1 - s3 * s2 * c1,
            c3 * s2 * c1 + s3 * c2 * s1,
            s3 * c2 * c1 - c3 * s2 * s1,
        ],
        axis=-1,
    )
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def load_quat_dataset(csv_path, verbose: bool = True) -> Dataset:
    """13-state quaternion + Fx..Mz contract, with legacy-Euler conversion
    and quaternion renormalisation."""
    df = _read(csv_path, verbose)
    has_euler = all(c in df for c in ("phi", "theta", "psi"))
    has_quat = all(c in df for c in ("qw", "qx", "qy", "qz"))
    if has_euler and not has_quat:
        if verbose:
            warn("Euler angles detected in dataset; converting to quaternions...")
        q = euler_to_quat_np(
            np.asarray(df["phi"], float),
            np.asarray(df["theta"], float),
            np.asarray(df["psi"], float),
        )
        df.update({k: q[:, i] for i, k in enumerate(("qw", "qx", "qy", "qz"))})
    ds = _clean_and_extract(df, QUAT13_COLS, WRENCH_COLS, verbose)
    q = ds.X[:, 3:7]
    ds.X[:, 3:7] = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return ds


def train_test_split(ds: Dataset, train_frac: float = 0.8, causal_overlap: bool = False):
    """Causal split; with ``causal_overlap`` the test range starts one
    sample early (the simulation workload's ``split - 1``)."""
    split = int(train_frac * len(ds.X))
    start = split - 1 if causal_overlap else split
    train = Dataset(ds.X[:split], ds.U[:split], ds.t[:split], ds.dt)
    test = Dataset(ds.X[start:], ds.U[start:], ds.t[start:], ds.dt)
    return train, test

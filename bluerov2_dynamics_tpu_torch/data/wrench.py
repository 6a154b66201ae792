"""Body wrench from thruster commands, on the host (numpy).

Counterpart of ``ROTOR_TABLE``, ``effectiveness_matrix`` and
``thrusters_to_wrench`` in ``bluerov2_dynamics_tpu/data/wrench.py``: the
normalised body wrench ``W = (E U^T)^T`` from the 6x8 effectiveness matrix
``E = [a ; r x a]`` of the BlueROV2-heavy rotor table, axes normalised.
This table describes the recorded vehicle and differs from the simulator's
geometry in ``models/params.py``; the T3/T4 apps use this one.
:func:`augment_csv` turns a thruster CSV into a wrench CSV (no pandas).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# (axis, position) per rotor of the BlueROV2-heavy frame.
ROTOR_TABLE: List[Tuple[Tuple[float, float, float], Tuple[float, float, float]]] = [
    ((1.0, -1.0, 0.0), (0.14, 0.10, 0.06)),
    ((1.0, 1.0, 0.0), (0.14, -0.10, 0.06)),
    ((1.0, 1.0, 0.0), (-0.14, 0.10, 0.06)),
    ((1.0, -1.0, 0.0), (-0.14, -0.10, 0.06)),
    ((0.0, 0.0, -1.0), (0.12, 0.22, 0.00)),
    ((0.0, 0.0, 1.0), (0.12, -0.22, 0.00)),
    ((0.0, 0.0, 1.0), (-0.12, 0.22, 0.00)),
    ((0.0, 0.0, -1.0), (-0.12, -0.22, 0.00)),
]


def effectiveness_matrix(rotors=None, normalize_axes: bool = True) -> np.ndarray:
    """6x8 matrix mapping per-rotor normalised thrust to body wrench."""
    rotors = rotors if rotors is not None else ROTOR_TABLE
    E = np.zeros((6, len(rotors)))
    for i, (axis, pos) in enumerate(rotors):
        a = np.asarray(axis, float)
        if normalize_axes:
            n = np.linalg.norm(a)
            if n > 0:
                a = a / n
        r = np.asarray(pos, float)
        E[0:3, i] = a
        E[3:6, i] = np.cross(r, a)
    return E


def thrusters_to_wrench(U: np.ndarray, rotors=None) -> np.ndarray:
    """(N, 8) normalised commands -> (N, 6) normalised body wrench."""
    return U @ effectiveness_matrix(rotors).T


def augment_csv(
    in_path,
    out_path=None,
    setpoint_names: bool = False,
    drop_inputs: bool = True,
):
    """Read a thruster CSV, append wrench columns, write ``out_path``.

    Returns the output path.  Actuator columns are ``u1..u8`` if present,
    else the last eight numeric columns.  Default names are ``Fx..Mz``;
    ``setpoint_names=True`` writes ``Fx_sp..Tz_sp``.  Only the numeric
    columns are kept (a column that does not parse as numbers is dropped
    with a warning); the rest is the JAX package's ``augment_csv``, its
    output read back equal in float64.
    """
    from pathlib import Path

    from bluerov2_dynamics_tpu_torch.data import table as tb
    from bluerov2_dynamics_tpu_torch.utils.log import info, warn

    in_path = Path(in_path)
    out_path = Path(out_path) if out_path else in_path.with_name(
        in_path.stem + "_with_wrench.csv"
    )
    df = tb.read_csv(in_path)
    text = [c for c, v in df.items() if v.dtype == object]
    if text:
        warn(f"dropping non-numeric columns: {text}")
        df = {c: v for c, v in df.items() if v.dtype != object}
    u_cols = [f"u{i}" for i in range(1, 9)]
    if not all(c in df for c in u_cols):
        numeric = list(df)
        if len(numeric) < 8:
            raise ValueError("Could not find 8 actuator columns.")
        u_cols = numeric[-8:]
    info("Using actuator columns:", u_cols)

    U = np.stack([df[c] for c in u_cols], axis=1).astype(float)
    if np.nanmax(np.abs(U)) > 1.05:
        warn("actuator values exceed ~[-1,1]. Proceeding anyway.")
    W = thrusters_to_wrench(U)

    out = {c: v for c, v in df.items() if not (drop_inputs and c in u_cols)}
    names = (
        ["Fx_sp", "Fy_sp", "Fz_sp", "Tx_sp", "Ty_sp", "Tz_sp"]
        if setpoint_names
        else ["Fx", "Fy", "Fz", "Mx", "My", "Mz"]
    )
    for j, name in enumerate(names):
        out[name] = W[:, j]
    tb.write_csv(out_path, out)
    info("Wrote:", out_path)
    return out_path

"""Body wrench from thruster commands, on the host (numpy).

Counterpart of ``ROTOR_TABLE``, ``effectiveness_matrix`` and
``thrusters_to_wrench`` in ``bluerov2_dynamics_tpu/data/wrench.py``: the
normalised body wrench ``W = (E U^T)^T`` from the 6x8 effectiveness matrix
``E = [a ; r x a]`` of the BlueROV2-heavy rotor table, axes normalised.
This table describes the recorded vehicle and differs from the simulator's
geometry in ``models/params.py``; the T3/T4 apps use this one.
The CSV augmentation (``augment_csv``) comes with the port's CSV path.
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

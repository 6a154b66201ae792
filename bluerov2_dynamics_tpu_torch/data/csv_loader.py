"""Host-side conversions of the CSV data path (numpy).

Counterpart of ``euler_to_quat_np`` in
``bluerov2_dynamics_tpu/data/csv_loader.py``.  The CSV loaders themselves
come with a later slice of the port.
"""

from __future__ import annotations

import numpy as np


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

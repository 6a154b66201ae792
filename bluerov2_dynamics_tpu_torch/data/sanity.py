"""Dataset sanity checks (vectorized host-side).

Counterpart of ``bluerov2_dynamics_tpu/data/sanity.py``: three validation
checks on a loaded tank dataset —

1. kinematic consistency: finite-difference ż vs the body velocity rotated
   to the world frame (RMSE + correlation);
2. actuator sign sanity: per-thruster correlation of ``u_i`` with ż;
3. passive buoyancy drift during near-zero-command segments.

The rotation is one vectorized expression.  Returned as a dict so apps/tests can assert on it (the
reference only prints).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from bluerov2_dynamics_tpu_torch.utils.log import info, ok


def kinematic_consistency(t, z, uvw, euler) -> Dict[str, float]:
    """Check 1: ż from finite differences vs (R_b2n @ [u,v,w])_z."""
    zdot_fd = np.gradient(z, t)
    phi, theta = euler[:, 0], euler[:, 1]
    # third row of R_b2n: [-sin(th), cos(th) sin(phi), cos(th) cos(phi)]
    zdot_body = (
        -np.sin(theta) * uvw[:, 0]
        + np.cos(theta) * np.sin(phi) * uvw[:, 1]
        + np.cos(theta) * np.cos(phi) * uvw[:, 2]
    )
    rmse = float(np.sqrt(np.mean((zdot_fd - zdot_body) ** 2)))
    corr = float(np.corrcoef(zdot_fd, zdot_body)[0, 1])
    return {"rmse": rmse, "corr": corr, "zdot_fd": zdot_fd}


def actuator_sign_correlations(U, zdot_fd) -> np.ndarray:
    """Check 2: corr(u_i, ż) per thruster."""
    return np.array(
        [float(np.corrcoef(U[:, i], zdot_fd)[0, 1]) for i in range(U.shape[1])]
    )


def buoyancy_drift(z, U, threshold: float = 0.05):
    """Check 3: depth drift over samples where all |u_i| < threshold.

    Returns the drift in meters, or None if no such segment exists.
    """
    near_zero = np.max(np.abs(U), axis=1) < threshold
    if not near_zero.any():
        return None
    z_seg = z[near_zero]
    return float(z_seg[-1] - z_seg[0])


def run_all(ds, verbose: bool = True) -> Dict:
    """Run all checks on a thruster :class:`~..data.csv_loader.Dataset`."""
    X, U, t = ds.X, ds.U, ds.t
    kin = kinematic_consistency(t, X[:, 2], X[:, 6:9], X[:, 3:6])
    corrs = actuator_sign_correlations(U, kin["zdot_fd"])
    drift = buoyancy_drift(X[:, 2], U)
    if verbose:
        ok(f"ż FD vs rotate(w): RMSE={kin['rmse']:.4f} m/s, corr={kin['corr']:.3f}")
        ok("corr(u_i, ż):", [f"{c:.3f}" for c in corrs])
        if drift is None:
            info("No long u≈0 segment found; skip buoyancy drift check.")
        else:
            ok(f"Δz during u≈0 segment: {drift:.3f} m")
    return {"kinematic": {k: v for k, v in kin.items() if k != "zdot_fd"},
            "actuator_corrs": corrs, "buoyancy_drift": drift}

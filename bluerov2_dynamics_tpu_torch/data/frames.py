"""Frame/sign-convention discovery between mocap and PX4 gyro streams.

Counterpart of ``bluerov2_dynamics_tpu/data/frames.py``, with no pandas:
align the mocap angular twist with the PX4 gyro (SensorCombined preferred,
else VehicleOdometry) by nearest time, then score every combination of
{twist as-is, parent->body rotated} x {identity, flip_yz, flip_xz, flip_xy}
sign conventions and report a verdict.

The score is the *signed* correlation sum (a correct sign convention makes
every axis correlate positively): a sum of per-axis |correlation| is
invariant under diagonal sign flips, so its candidate scan would always
tie.

The scoring core is pure-array (unit-testable); the bag extraction uses
the optional ``rosbags`` package when installed, else the built-in
sqlite3 + CDR reader.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bluerov2_dynamics_tpu_torch.data import table as tb
from bluerov2_dynamics_tpu_torch.data.bag2csv import BagTopics, quat_dcm
from bluerov2_dynamics_tpu_torch.utils.log import info, warn

FLIPS: Dict[str, np.ndarray] = {
    "identity": np.diag([1.0, 1.0, 1.0]),
    "flip_yz": np.diag([1.0, -1.0, -1.0]),  # common ENU<->NED body difference
    "flip_xz": np.diag([-1.0, 1.0, -1.0]),
    "flip_xy": np.diag([-1.0, -1.0, 1.0]),
}


def axis_correlation(a: np.ndarray, b: np.ndarray) -> float:
    """NaN-tolerant normalized correlation, averaged over axes."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if a.ndim == 1:
        a = a[:, None]
    if b.ndim == 1:
        b = b[:, None]
    a = a - np.nanmean(a, axis=0)
    b = b - np.nanmean(b, axis=0)
    den = np.sqrt(np.nanmean(a * a, axis=0) * np.nanmean(b * b, axis=0))
    den = np.where(den == 0, np.nan, den)
    return float(np.nanmean(np.nanmean(a * b / den, axis=0)))


def score_conventions(
    t_mocap, W_mocap, quats_xyzw, t_gyro, G_gyro,
    align_tol: float = 0.03, verbose: bool = True,
):
    """Test mocap-twist frame/sign hypotheses against the gyro.

    Returns the best hypothesis per mocap mode:
    ``{mode: {flip, cx, cy, cz, score, n}}``.
    """
    W_as_is = np.asarray(W_mocap, float)
    R = quat_dcm(quats_xyzw)
    W_rotated = np.einsum("nij,nj->ni", R, W_as_is)  # parent -> body hypothesis

    dfp = tb.sort_by(
        {"t": np.asarray(t_gyro, float),
         "gx": G_gyro[:, 0], "gy": G_gyro[:, 1], "gz": G_gyro[:, 2]}
    )

    results = {}
    for mode, W in (("as_is", W_as_is), ("rotated", W_rotated)):
        dm = tb.sort_by(
            {"t": np.asarray(t_mocap, float),
             "mx": W[:, 0], "my": W[:, 1], "mz": W[:, 2]}
        )
        merged = tb.dropna(tb.merge_asof_nearest(dm, dfp, "t", tolerance=align_tol))
        if tb.nrows(merged) == 0:
            if verbose:
                warn(f"No overlap for mode={mode}.")
            continue
        M = np.stack([merged[k] for k in ("mx", "my", "mz")], axis=1)
        G = np.stack([merged[k] for k in ("gx", "gy", "gz")], axis=1)
        best = None
        for flip_name, S in FLIPS.items():
            Mc = M @ S.T
            cs = [axis_correlation(Mc[:, i], G[:, i]) for i in range(3)]
            score = sum(cs)  # signed: see module docstring
            if best is None or score > best["score"]:
                best = {"flip": flip_name, "cx": cs[0], "cy": cs[1],
                        "cz": cs[2], "score": score, "n": tb.nrows(merged)}
        results[mode] = best
        if verbose and best:
            info(f"Candidate result: mocap_mode={mode} flip={best['flip']} "
                 f"(N={best['n']})")
            info(f"  corr(p): {best['cx']:+.3f}  corr(q): {best['cy']:+.3f}  "
                 f"corr(r): {best['cz']:+.3f}")
            if best["score"] > 2.0:
                info("  -> Strong match.")
            elif best["score"] > 1.2:
                info("  -> Moderate match (some axis noisier).")
            else:
                info("  -> Weak match; sensors may be desynced or filtered differently.")
    return results


def compare_bag(bag_path, topics: BagTopics = BagTopics(),
                sensor_combined_topic: Optional[str] = None,
                align_tol: float = 0.03):
    """Full pipeline on a rosbag2 recording.

    Uses the ``rosbags`` package when installed, else the built-in
    sqlite3+CDR reader (:mod:`bag_sqlite`).
    """
    try:
        from rosbags.highlevel import AnyReader
        from rosbags.typesys import Stores, get_typestore
    except ImportError:
        return _compare_bag_sqlite(bag_path, topics, sensor_combined_topic,
                                   align_tol)

    from pathlib import Path

    from bluerov2_dynamics_tpu_torch.data.px4_msgs import register_px4_types

    sc_topic = sensor_combined_topic or topics.px4_odom.replace(
        "vehicle_odometry", "sensor_combined"
    )
    with AnyReader([Path(bag_path)], default_typestore=get_typestore(Stores.ROS2_HUMBLE)) as reader:
        register_px4_types(reader.typestore)
        conns = {c.topic: c for c in reader.connections}
        if topics.mocap_odom not in conns:
            raise RuntimeError(
                f"Missing {topics.mocap_odom}. Available: {sorted(conns)}"
            )
        t0 = None

        def rel(ts):
            nonlocal t0
            if t0 is None:
                t0 = ts
            return (ts - t0) * 1e-9

        mo = []
        for c, ts, raw in reader.messages(connections=[conns[topics.mocap_odom]]):
            t = rel(ts)
            m = reader.deserialize(raw, c.msgtype)
            o = m.pose.pose.orientation
            w = m.twist.twist.angular
            mo.append((t, o.x, o.y, o.z, o.w, w.x, w.y, w.z))
        mo = np.asarray(mo, float)

        gy = []
        if sc_topic in conns:
            for c, ts, raw in reader.messages(connections=[conns[sc_topic]]):
                m = reader.deserialize(raw, c.msgtype)
                gy.append((rel(ts), *[float(v) for v in m.gyro_rad]))
        elif topics.px4_odom in conns:
            for c, ts, raw in reader.messages(connections=[conns[topics.px4_odom]]):
                m = reader.deserialize(raw, c.msgtype)
                gy.append((rel(ts), *[float(v) for v in m.angular_velocity]))
        else:
            raise RuntimeError(
                f"Neither {sc_topic} nor {topics.px4_odom} present."
            )
        gy = np.asarray(gy, float)

    return score_conventions(
        mo[:, 0], mo[:, 5:8], mo[:, 1:5], gy[:, 0], gy[:, 1:4], align_tol
    )


def _compare_bag_sqlite(bag_path, topics: BagTopics,
                        sensor_combined_topic: Optional[str],
                        align_tol: float):
    """Dependency-free extraction path (sqlite3 + minimal CDR codec)."""
    from bluerov2_dynamics_tpu_torch.data.bag_sqlite import (
        find_db3,
        iter_messages,
        topics_of,
    )

    db3 = find_db3(bag_path)
    tops = topics_of(db3)
    if topics.mocap_odom not in tops:
        raise RuntimeError(
            f"Missing {topics.mocap_odom}. Available: {sorted(tops)}"
        )
    sc_topic = sensor_combined_topic or topics.px4_odom.replace(
        "vehicle_odometry", "sensor_combined"
    )
    t0 = None

    def rel(ts):
        nonlocal t0
        if t0 is None:
            t0 = ts
        return (ts - t0) * 1e-9

    mo = []
    for ts, m in iter_messages(db3, topics.mocap_odom):
        o = m.pose.pose.orientation
        w = m.twist.twist.angular
        mo.append((rel(ts), o.x, o.y, o.z, o.w, w.x, w.y, w.z))
    mo = np.asarray(mo, float)

    gy = []
    if sc_topic in tops:
        for ts, m in iter_messages(db3, sc_topic):
            gy.append((rel(ts), *m.gyro_rad))
    elif topics.px4_odom in tops:
        for ts, m in iter_messages(db3, topics.px4_odom):
            gy.append((rel(ts), *m.angular_velocity))
    else:
        raise RuntimeError(f"Neither {sc_topic} nor {topics.px4_odom} present.")
    gy = np.asarray(gy, float)

    return score_conventions(
        mo[:, 0], mo[:, 5:8], mo[:, 1:5], gy[:, 0], gy[:, 1:4], align_tol
    )

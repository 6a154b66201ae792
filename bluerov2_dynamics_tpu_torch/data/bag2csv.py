"""rosbag2 -> 50 Hz training CSV ingestion (host-side, no pandas).

Counterpart of ``bluerov2_dynamics_tpu/data/bag2csv.py``: decode a rosbag2
recording into the training CSV contract ``t, x..r, u1..u8`` with

* source priority mocap Odometry -> mocap Pose+Twist -> PX4
  VehicleOdometry (NED->ENU conversion);
* automatic twist-frame inference (finite-difference world velocity vs
  body-rotated twist RMSE);
* actuator extraction from ActuatorMotors with NaN diagnostics and
  clipping to [-1, 1];
* Euler unwrap -> time resample -> interpolate -> nearest-time actuator
  merge (tolerance = half period) -> ffill/bfill/clip.

The JAX package does the resample and joins with pandas; here they are
numpy with pandas' exact semantics (:mod:`.table`), so the CSV this
module writes reads back equal, in float64, to the JAX package's on the
same bag, and the path runs where pandas is absent.  Tables are ordered
``dict[str, np.ndarray]``.  The ``rosbags`` branch of :func:`read_bag`
imports ``rosbags`` inside; without it :func:`convert` reads the bag with
the built-in sqlite3 + CDR reader (:mod:`.bag_sqlite`).

CLI: ``python -m bluerov2_dynamics_tpu_torch.data.bag2csv BAG_DIR [--out
BASE] [--hz 50] [--parquet] [--video PATH]``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from bluerov2_dynamics_tpu_torch.data import table as tb
from bluerov2_dynamics_tpu_torch.utils.log import info, ok, warn

STATE_COLS = ["x", "y", "z", "phi", "theta", "psi", "u", "v", "w", "p", "q", "r"]
ACT_COLS = [f"u{i}" for i in range(1, 9)]


@dataclasses.dataclass(frozen=True)
class BagTopics:
    """Topic names (defaults match the reference recording layout)."""

    mocap_odom: str = "/mocap/itrl_rov_1/odom"
    mocap_pose: str = "/mocap/itrl_rov_1/pose"
    mocap_vel: str = "/mocap/itrl_rov_1/velocity"
    px4_odom: str = "/itrl_rov_1/fmu/out/vehicle_odometry"
    px4_motors: str = "/itrl_rov_1/fmu/out/actuator_motors"


# --------------------------- vectorized math ---------------------------

def quat_dcm(q_xyzw: np.ndarray) -> np.ndarray:
    """Quaternion(s) (x, y, z, w) -> DCM stack ``(..., 3, 3)``; applied to
    a world vector it expresses it in the body frame under the
    recording's convention."""
    q = np.asarray(q_xyzw, float)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = q / np.where(n == 0, 1.0, n)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty((*q.shape[:-1], 3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_to_euler_xyzw(q_xyzw: np.ndarray):
    """Quaternion(s) (x, y, z, w) -> (phi, theta, psi), vectorized."""
    q = np.asarray(q_xyzw, float)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    phi = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
    theta = np.arcsin(sinp)
    psi = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return phi, theta, psi


def ned_to_enu(v: np.ndarray) -> np.ndarray:
    """NED -> ENU axis swap (x<->y, z negated), vectorized."""
    v = np.asarray(v, float)
    return np.stack([v[..., 1], v[..., 0], -v[..., 2]], axis=-1)


def ned_quat_to_enu(q_xyzw: np.ndarray) -> np.ndarray:
    """NED-frame quaternion -> ENU-frame quaternion via the Euler route:
    (phi,theta,psi)_NED -> (theta,phi,-psi)_ENU."""
    phi, theta, psi = quat_to_euler_xyzw(q_xyzw)
    phi_e, theta_e, psi_e = theta, phi, -psi
    cx, sx = np.cos(phi_e / 2), np.sin(phi_e / 2)
    cy, sy = np.cos(theta_e / 2), np.sin(theta_e / 2)
    cz, sz = np.cos(psi_e / 2), np.sin(psi_e / 2)
    return np.stack(
        [
            sx * cy * cz - cx * sy * sz,   # x
            cx * sy * cz + sx * cy * sz,   # y
            cx * cy * sz - sx * sy * cz,   # z
            cx * cy * cz + sx * sy * sz,   # w
        ],
        axis=-1,
    )


def infer_twist_frame(times, pos_world, lin_twist, quats_xyzw, verbose=True) -> str:
    """'parent' (world) vs 'body' twist-frame inference: finite-difference
    world velocity against (a) the twist as-is and (b) the twist rotated
    body->world; the lower RMSE wins."""
    t = np.asarray(times, float)
    if len(t) < 5:
        return "parent"
    p = np.asarray(pos_world, float)
    v_msg = np.asarray(lin_twist, float)
    v_fd = np.gradient(p, t, axis=0)
    R = quat_dcm(quats_xyzw)                       # (N, 3, 3)
    v_b2w = np.einsum("nji,nj->ni", R, v_msg)      # R^T @ v per row
    e_parent = float(np.sqrt(np.mean((v_fd - v_msg) ** 2)))
    e_body = float(np.sqrt(np.mean((v_fd - v_b2w) ** 2)))
    which = "parent" if e_parent <= e_body else "body"
    if verbose:
        info(
            f"Twist frame inference: {which} "
            f"(RMSE world={e_parent:.4f}, body->world={e_body:.4f})"
        )
    return which


def odom_table(times, pos, quats_xyzw, lin, ang, mode: str) -> tb.Table:
    """The odometry table ``t, x..r`` with body-frame velocities.

    ``mode='parent'``: twists are world-frame and get rotated into the body
    frame; ``'body'``: twists pass through.
    """
    t = np.asarray(times, float)
    pos = np.asarray(pos, float)
    q = np.asarray(quats_xyzw, float)
    lin = np.asarray(lin, float)
    ang = np.asarray(ang, float)
    phi, theta, psi = quat_to_euler_xyzw(q)
    if mode == "parent":
        R = quat_dcm(q)
        lin = np.einsum("nij,nj->ni", R, lin)
        ang = np.einsum("nij,nj->ni", R, ang)
    return {
        "t": t,
        "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
        "phi": phi, "theta": theta, "psi": psi,
        "u": lin[:, 0], "v": lin[:, 1], "w": lin[:, 2],
        "p": ang[:, 0], "q": ang[:, 1], "r": ang[:, 2],
    }


def pose_twist_odometry(pose_rows, vel_rows, verbose: bool = True) -> tb.Table:
    """Odometry from separate pose and twist streams: each pose row
    ``(t, px, py, pz, qx, qy, qz, qw)`` joined to the twist row ``(t, vlx,
    vly, vlz, vax, vay, vaz)`` nearest in time within 0.01 s
    (``merge_asof`` of the time-sorted streams), rows without one (or
    with a NaN) dropped, then the twist frame inferred."""
    def sorted_table(rows, names):
        a = np.asarray(rows, float).reshape(-1, len(names))
        return tb.sort_by({n: a[:, i] for i, n in enumerate(names)})

    dfp = sorted_table(pose_rows, ["t", "px", "py", "pz", "qx", "qy", "qz", "qw"])
    dfv = sorted_table(vel_rows, ["t", "vlx", "vly", "vlz", "vax", "vay", "vaz"])
    dfm = tb.dropna(tb.merge_asof_nearest(dfp, dfv, "t", tolerance=0.5 / 50.0))
    cols = lambda *names: np.stack([dfm[n] for n in names]).T  # noqa: E731
    quats = cols("qx", "qy", "qz", "qw")
    pos, lin = cols("px", "py", "pz"), cols("vlx", "vly", "vlz")
    mode = infer_twist_frame(dfm["t"], pos, lin, quats, verbose)
    return odom_table(dfm["t"], pos, quats, lin, cols("vax", "vay", "vaz"), mode)


# --------------------------- actuator diagnostics ---------------------------

@dataclasses.dataclass
class ActuatorReport:
    total: int
    nan_any: int
    nan_per_chan: np.ndarray          # (8,)
    valid_count_hist: np.ndarray      # (9,)
    raw_min: float
    raw_max: float


def actuator_diagnostics(raw: np.ndarray, verbose: bool = True) -> ActuatorReport:
    """NaN diagnostics over raw (N, 8) actuator values, vectorized."""
    raw = np.asarray(raw, float)
    isn = np.isnan(raw)
    nan_per_chan = isn.sum(axis=0)
    valid_counts = (~isn).sum(axis=1)
    hist = np.bincount(valid_counts, minlength=9)
    rep = ActuatorReport(
        total=len(raw),
        nan_any=int(isn.any(axis=1).sum()),
        nan_per_chan=nan_per_chan,
        valid_count_hist=hist,
        raw_min=float(np.nanmin(raw)) if len(raw) else float("nan"),
        raw_max=float(np.nanmax(raw)) if len(raw) else float("nan"),
    )
    if verbose and rep.total:
        info("Actuator messages:", rep.total)
        info(f"Raw actuator msgs w/ any NaN: {rep.nan_any} "
             f"({100.0 * rep.nan_any / rep.total:.2f}%)")
        for i in range(8):
            info(f" NaNs in u{i+1}: {nan_per_chan[i]} "
                 f"({100.0 * nan_per_chan[i] / rep.total:.2f}%)")
        info(f"Actuator raw range: [{rep.raw_min:.3f}, {rep.raw_max:.3f}]")
    return rep


def actuator_table(times, raw: np.ndarray) -> tb.Table:
    """(N,) times + raw (N, 8) -> the cleaned actuator table ``t, u1..u8``:
    NaN->0, clipped to [-1, 1], sorted by time."""
    vals = np.clip(np.nan_to_num(np.asarray(raw, float), nan=0.0), -1.0, 1.0)
    df = {"t": np.asarray(times, float)}
    for i in range(8):
        df[f"u{i+1}"] = vals[:, i]
    return tb.sort_by(df)


# --------------------------- resample & join ---------------------------

def resample_and_join(
    df_odom: tb.Table,
    df_act: Optional[tb.Table],
    hz: float = 50.0,
    verbose: bool = True,
) -> tb.Table:
    """Unwrap Euler angles, resample states to ``hz``, merge actuators by
    nearest time (tolerance = half period), gap-fill and clip.

    pandas' semantics, step by step (each pinned against pandas in
    ``tests/test_torch_bag2csv.py``): the angles are unwrapped in row order
    BEFORE binning; times become integer nanoseconds (:func:`.table.to_ns`);
    the bins start at the first sample (:func:`.table.resample_mean`); an
    empty bin is filled by linear interpolation in time
    (:func:`.table.interpolate_time`); ``t`` is the bin start in seconds;
    the actuators join by ``merge_asof(direction="nearest")`` within half
    a period (:func:`.table.asof_nearest`), then ffill, bfill, 0, clip to
    [-1, 1]; an inf state becomes NaN and rows with a NaN state are
    dropped.  ``hz=0`` skips the resample.
    """
    if not df_odom or tb.nrows(df_odom) == 0:
        raise RuntimeError("No odometry rows.")
    df_odom = {k: np.array(v, np.float64) for k, v in df_odom.items()}
    for ang in ("phi", "theta", "psi"):
        df_odom[ang] = np.unwrap(df_odom[ang])

    if hz and hz > 0:
        ns = tb.to_ns(df_odom["t"])
        labels, means = tb.resample_mean(
            ns, {k: v for k, v in df_odom.items() if k != "t"}, tb.step_ns(hz))
        df_odom = {k: tb.interpolate_time(labels, v) for k, v in means.items()}
        df_odom["t"] = labels / 1e9  # TimedeltaIndex.total_seconds()

    n = tb.nrows(df_odom)
    if df_act is not None and tb.nrows(df_act) > 0:
        tol = 0.5 / float(hz if hz else 50.0)
        left_t = df_odom["t"][tb.sort_index(df_odom["t"])]
        act = tb.sort_by(df_act)
        j = tb.asof_nearest(left_t, act["t"], tol)
        # pd.concat(axis=1) pairs the sorted merge with df_odom by row label:
        # row i of the merge beside row i of df_odom
        acts = {c: np.where(j >= 0, np.asarray(act[c], np.float64)[np.maximum(j, 0)], np.nan)
                for c in ACT_COLS}
        if verbose:
            n_nan = int(sum(np.isnan(acts[c]).sum() for c in ACT_COLS))
            total = n * len(ACT_COLS)
            info(f"After merge (before fill): NaN cells in u1..u8 = "
                 f"{n_nan}/{total} ({100.0 * n_nan / max(1, total):.2f}%)")
    else:
        acts = {c: np.full(n, np.nan) for c in ACT_COLS}

    for c in ACT_COLS:
        a = tb.bfill(tb.ffill(acts[c]))
        acts[c] = np.clip(np.where(np.isnan(a), 0.0, a), -1.0, 1.0)
    out = {"t": df_odom["t"], **{c: df_odom[c] for c in STATE_COLS}, **acts}
    for c in STATE_COLS:
        out[c] = np.where(np.isinf(out[c]), np.nan, out[c])
    return tb.dropna(out, subset=STATE_COLS)


# --------------------------- bag reading (gated) ---------------------------

def read_bag(bag_path, topics: BagTopics = BagTopics(), verbose: bool = True
             ) -> Tuple[tb.Table, Optional[tb.Table]]:
    """Decode odometry + actuators from a rosbag2 directory.

    Requires the optional ``rosbags`` package.  Source priority: mocap
    Odometry, then mocap Pose+Twist, then PX4 VehicleOdometry (NED->ENU).
    """
    try:
        from rosbags.highlevel import AnyReader
        from rosbags.typesys import Stores, get_typestore
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "rosbag ingestion requires the optional 'rosbags' package "
            "(pip install rosbags); the CSV contract downstream is unchanged."
        ) from e

    from bluerov2_dynamics_tpu_torch.data.px4_msgs import register_px4_types

    bag_path = Path(bag_path)
    if not bag_path.exists():
        raise FileNotFoundError(f"Bag not found: {bag_path}")

    def typestore():
        for s in (Stores.ROS2_HUMBLE, Stores.ROS2_GALACTIC, Stores.ROS2_FOXY):
            try:
                return get_typestore(s)
            except Exception:
                continue
        return get_typestore(Stores.ROS2_FOXY)

    with AnyReader([bag_path], default_typestore=typestore()) as reader:
        register_px4_types(reader.typestore)
        conns = {c.topic: c for c in reader.connections}
        t0 = None

        def rel_time(ts):
            nonlocal t0
            if t0 is None:
                t0 = ts
            return (ts - t0) * 1e-9

        def collect(topic, fields):
            rows = []
            for c, ts, data in reader.messages(connections=[conns[topic]]):
                t = rel_time(ts)
                try:
                    m = reader.deserialize(data, c.msgtype)
                except Exception:
                    continue
                rows.append((t, fields(m)))
            return rows

        if topics.mocap_odom in conns:
            rows = collect(
                topics.mocap_odom,
                lambda m: (
                    (m.pose.pose.position.x, m.pose.pose.position.y, m.pose.pose.position.z),
                    (m.pose.pose.orientation.x, m.pose.pose.orientation.y,
                     m.pose.pose.orientation.z, m.pose.pose.orientation.w),
                    (m.twist.twist.linear.x, m.twist.twist.linear.y, m.twist.twist.linear.z),
                    (m.twist.twist.angular.x, m.twist.twist.angular.y, m.twist.twist.angular.z),
                    getattr(m, "child_frame_id", ""),
                ),
            )
            times = [t for t, _ in rows]
            pos = [r[0] for _, r in rows]
            quats = [r[1] for _, r in rows]
            lin = [r[2] for _, r in rows]
            ang = [r[3] for _, r in rows]
            frames = [r[4] for _, r in rows]
            mode = None
            if frames and any(frames):
                cf = frames[len(frames) // 2]
                if isinstance(cf, str) and any(k in cf for k in ("base_link", "body", "base")):
                    mode = "body"
            if mode is None:
                mode = infer_twist_frame(times, pos, lin, quats, verbose)
            df_odom = odom_table(times, pos, quats, lin, ang, mode)

        elif topics.mocap_pose in conns and topics.mocap_vel in conns:
            pose_rows = collect(
                topics.mocap_pose,
                lambda m: (m.pose.position.x, m.pose.position.y, m.pose.position.z,
                           m.pose.orientation.x, m.pose.orientation.y,
                           m.pose.orientation.z, m.pose.orientation.w),
            )
            vel_rows = collect(
                topics.mocap_vel,
                lambda m: (m.twist.linear.x, m.twist.linear.y, m.twist.linear.z,
                           m.twist.angular.x, m.twist.angular.y, m.twist.angular.z),
            )
            df_odom = pose_twist_odometry([(t, *r) for t, r in pose_rows],
                                          [(t, *r) for t, r in vel_rows], verbose)

        elif topics.px4_odom in conns:
            rows = collect(
                topics.px4_odom,
                lambda m: (
                    tuple(float(v) for v in m.position),
                    # PX4 q is (w, x, y, z); reorder to (x, y, z, w)
                    (float(m.q[1]), float(m.q[2]), float(m.q[3]), float(m.q[0])),
                    tuple(float(v) for v in m.velocity),
                    tuple(float(v) for v in m.angular_velocity),
                ),
            )
            times = [t for t, _ in rows]
            pos = ned_to_enu(np.asarray([r[0] for _, r in rows]))
            quats = ned_quat_to_enu(np.asarray([r[1] for _, r in rows]))
            lin = ned_to_enu(np.asarray([r[2] for _, r in rows]))
            ang = ned_to_enu(np.asarray([r[3] for _, r in rows]))
            df_odom = odom_table(times, pos, quats, lin, ang, mode="parent")

        else:
            avail = sorted(conns)
            raise RuntimeError(
                "No pose/odometry stream found. Looked for "
                f"{topics.mocap_odom}, {topics.mocap_pose}+{topics.mocap_vel}, "
                f"{topics.px4_odom}. Available: {avail}"
            )

        df_act = None
        if topics.px4_motors in conns:
            rows = collect(
                topics.px4_motors,
                lambda m: tuple(float(v) for v in list(m.control)[:8]),
            )
            if rows:
                times = [t for t, _ in rows]
                raw = np.asarray([r for _, r in rows], float)
                actuator_diagnostics(raw, verbose)
                df_act = actuator_table(times, raw)
        elif verbose:
            info("Actuator topic not present.")

    return tb.sort_by(df_odom), df_act


def validate_against_metadata(bag_path, topics: BagTopics = BagTopics(),
                              hz: float = 50.0):
    """Cross-check the configured topics against the bag's ``metadata.yaml``.

    Each topic must exist, be CDR-serialized, have a decoder (hand-written
    :data:`..data.cdr.DECODERS` or a :mod:`..data.typesys` schema), and
    carry messages at a rate at or above the resample target ``hz``.

    Returns ``(BagMetadata, report)`` where ``report`` maps each
    ``BagTopics`` field to a dict with ``topic / found / type / decodable /
    rate_hz / issues``; prints ``[i]/[warn]`` lines per topic.  Raises
    ``FileNotFoundError`` if the bag directory has no ``metadata.yaml``.
    """
    from bluerov2_dynamics_tpu_torch.data import bagmeta, cdr, typesys

    meta = bagmeta.read_metadata(bag_path)
    decodable_types = set(cdr.DECODERS) | set(typesys.default_typestore().types)
    report = {}
    for field in dataclasses.fields(BagTopics):
        name = getattr(topics, field.name)
        entry = {"topic": name, "found": False, "type": None,
                 "decodable": False, "rate_hz": 0.0, "issues": []}
        report[field.name] = entry
        try:
            t = meta.topic(name)
        except KeyError:
            entry["issues"].append("topic not in recording")
            warn(f"{field.name}: topic {name!r} not in the recording")
            continue
        entry["found"] = True
        entry["type"] = t.type
        entry["decodable"] = t.type in decodable_types
        entry["rate_hz"] = meta.rate_hz(name)
        if t.serialization_format != "cdr":
            entry["issues"].append(
                f"serialization {t.serialization_format!r} != 'cdr'")
        if not entry["decodable"]:
            entry["issues"].append(f"no decoder for type {t.type!r}")
        if t.message_count == 0:
            entry["issues"].append("0 messages")
        elif entry["rate_hz"] < hz:
            # whole-recording mean: metadata has no per-topic start/end
            # time, so a late-starting topic under-reports its live rate
            entry["issues"].append(
                f"whole-recording mean rate {entry['rate_hz']:.1f} Hz "
                f"below the {hz:.0f} Hz resample target (may just start "
                "late/stop early)")
        if entry["issues"]:
            warn(f"{field.name}: {name} -> " + "; ".join(entry["issues"]))
        else:
            info(f"{field.name}: {name} [{t.type}] "
                 f"{t.message_count} msgs @ {entry['rate_hz']:.1f} Hz")
    return meta, report


def convert(
    bag_path,
    out_base=None,
    topics: BagTopics = BagTopics(),
    hz: float = 50.0,
    write_parquet: bool = False,
    video_path: Optional[str] = None,
) -> Path:
    """Full pipeline: bag -> cleaned 50 Hz CSV (+ optional parquet/video)."""
    bag_path = Path(bag_path)
    info(f"Opening bag at: {bag_path}")
    if (bag_path / "metadata.yaml").exists():
        try:
            validate_against_metadata(bag_path, topics, hz)
        except Exception as e:  # diagnostics must never block ingestion
            warn(f"metadata.yaml validation failed: {e}")
    try:
        df_odom, df_act = read_bag(bag_path, topics)
    except ImportError:
        # dependency-free fallback: sqlite3 + minimal CDR codec
        from bluerov2_dynamics_tpu_torch.data.bag_sqlite import read_bag_sqlite

        info("'rosbags' not installed; using the built-in sqlite/CDR reader.")
        df_odom, df_act = read_bag_sqlite(bag_path, topics)
    if tb.nrows(df_odom) < 2:
        raise RuntimeError("Not enough odometry samples.")
    dt_med = float(np.median(np.diff(df_odom["t"])))
    info(f"Odom samples: {tb.nrows(df_odom)} | median dt ≈ {dt_med:.4f}s "
         f"(~{1.0 / max(dt_med, 1e-6):.1f} Hz)")
    df = resample_and_join(df_odom, df_act, hz)
    out_base = Path(out_base) if out_base else bag_path / f"koopman_dataset_{int(hz)}Hz"
    out_base.parent.mkdir(parents=True, exist_ok=True)
    # append, don't with_suffix: a dotted basename like --out run_v1.2
    # would have its ".2" silently replaced (run_v1.csv)
    csv_path = out_base.parent / (out_base.name + ".csv")
    tb.write_csv(csv_path, df)
    ok(f"Saved: {csv_path}")
    if write_parquet:
        pq_path = out_base.parent / (out_base.name + ".parquet")
        try:
            import pandas as pd

            pd.DataFrame(df).to_parquet(pq_path, index=False)
            ok(f"Saved: {pq_path}")
        except Exception as e:
            warn(f"Parquet not written: {e}")
    if video_path:
        from bluerov2_dynamics_tpu_torch.viz import animate_topdown

        stride = max(1, tb.nrows(df) // 4000)
        sub = tb.take(df, slice(None, None, stride))
        animate_topdown(
            # dt is the SUBSAMPLED step: the on-frame clock, the tail window
            # and the playback rate follow it
            {"bag": np.stack([sub[c] for c in STATE_COLS], axis=1)}, dt=dt_med * stride,
            save_path=video_path, title="Top-down trajectory", speed=6.0,
        )
    return csv_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag", help="rosbag2 directory")
    ap.add_argument("--out", default=None, help="output basename (no suffix)")
    ap.add_argument("--hz", type=float, default=50.0)
    ap.add_argument("--parquet", action="store_true")
    ap.add_argument("--video", default=None)
    for f in dataclasses.fields(BagTopics):
        ap.add_argument(f"--topic-{f.name.replace('_', '-')}", default=f.default)
    args = ap.parse_args(argv)
    topics = BagTopics(
        **{
            f.name: getattr(args, f"topic_{f.name}")
            for f in dataclasses.fields(BagTopics)
        }
    )
    return convert(args.bag, args.out, topics, args.hz, args.parquet, args.video)


if __name__ == "__main__":
    main()

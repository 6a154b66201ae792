"""Dependency-free rosbag2 reader (SQLite + CDR), no pandas.

Counterpart of ``bluerov2_dynamics_tpu/data/bag_sqlite.py``.  rosbag2's
default storage is a SQLite database (``.db3``) with ``topics`` and
``messages`` tables and CDR-serialized payloads; this module reads them
with the standard library's ``sqlite3`` plus the CDR codec in :mod:`.cdr`
or the native batch decoders (:mod:`.native_cdr`).  Tables are ordered
``dict[str, np.ndarray]`` (:mod:`.table`).

Only the message types the BlueROV2 pipeline consumes are decodable (see
``cdr.DECODERS`` and the :mod:`.typesys` schemas); unknown types are
skipped.  :data:`ROUTES` counts, per ``(topic, route)``, the messages each
topic's decoding took through ``"native"`` (one C call a topic) or
``"python"`` (the per-message codec).  :func:`write_bag_sqlite` writes a
recording in the same layout (the JAX package has no writer; tests and
``chip_smoke.py`` build their bags with it).
"""

from __future__ import annotations

import collections
import sqlite3
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from bluerov2_dynamics_tpu_torch.data import cdr
from bluerov2_dynamics_tpu_torch.data import table as tb
from bluerov2_dynamics_tpu_torch.data.bag2csv import (
    BagTopics,
    actuator_diagnostics,
    actuator_table,
    infer_twist_frame,
    ned_quat_to_enu,
    ned_to_enu,
    odom_table,
    pose_twist_odometry,
)
from bluerov2_dynamics_tpu_torch.utils.log import info, warn

ROUTES: collections.Counter = collections.Counter()

ROSBAG2_SCHEMA = """
CREATE TABLE topics(
  id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
  serialization_format TEXT NOT NULL, offered_qos_profiles TEXT NOT NULL);
CREATE TABLE messages(
  id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
  timestamp INTEGER NOT NULL, data BLOB NOT NULL);
"""


def write_bag_sqlite(bag_dir, streams: Dict[str, Tuple[str, object, list]]) -> Path:
    """Write a rosbag2 directory in its sqlite3 layout: ``streams`` maps a
    topic name to ``(type name, timestamps in ns, CDR blobs)``.  Returns
    the ``.db3`` path."""
    bag_dir = Path(bag_dir)
    bag_dir.mkdir(parents=True, exist_ok=True)
    db3 = bag_dir / f"{bag_dir.name}_0.db3"
    con = sqlite3.connect(db3)
    try:
        con.executescript(ROSBAG2_SCHEMA)
        first = 1
        for tid, (topic, (typ, stamps, blobs)) in enumerate(streams.items(), start=1):
            con.execute("INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')", (tid, topic, typ))
            stamps = np.asarray(stamps, np.int64).tolist()
            con.executemany("INSERT INTO messages VALUES (?, ?, ?, ?)",
                            zip(range(first, first + len(blobs)), [tid] * len(blobs), stamps,
                                blobs))
            first += len(blobs)
        con.commit()
    finally:
        con.close()
    return db3


def find_db3(bag_path) -> Path:
    """Locate the .db3 file of a rosbag2 directory (or accept a file path)."""
    bag_path = Path(bag_path)
    if bag_path.is_file() and bag_path.suffix == ".db3":
        return bag_path
    cands = sorted(bag_path.glob("*.db3"))
    if not cands:
        raise FileNotFoundError(f"No .db3 storage found under {bag_path}")
    return cands[0]


def topics_of(db3_path) -> Dict[str, Tuple[int, str]]:
    """Map topic name -> (topic_id, type_name)."""
    with sqlite3.connect(f"file:{Path(db3_path)}?mode=ro", uri=True) as con:
        rows = con.execute("SELECT id, name, type FROM topics").fetchall()
    return {name: (tid, typ) for tid, name, typ in rows}


_DEFAULT_STORE = None


def _default_store():
    """Module-cached default typestore: building it re-parses every PX4
    .msg definition."""
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        from bluerov2_dynamics_tpu_torch.data import typesys

        _DEFAULT_STORE = typesys.default_typestore()
    return _DEFAULT_STORE


def raw_messages(db3_path, topic: str, tops: Dict[str, Tuple[int, str]] = None):
    """All ``(timestamp_ns, blob)`` rows of a topic (for batch decoding).

    ``tops``: pass the result of :func:`topics_of` to avoid re-querying
    the topics table per topic read."""
    if tops is None:
        tops = topics_of(db3_path)
    if topic not in tops:
        return [], None
    tid, typ = tops[topic]
    with sqlite3.connect(f"file:{Path(db3_path)}?mode=ro", uri=True) as con:
        rows = con.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id = ? "
            "ORDER BY timestamp", (tid,),
        ).fetchall()
    return [(ts, bytes(b)) for ts, b in rows], typ


def iter_messages(db3_path, topic: str, typestore=None,
                  tops: Dict[str, Tuple[int, str]] = None) -> Iterator[Tuple[int, object]]:
    """Yield ``(timestamp_ns, decoded_message)`` for one topic.

    Types without a hand-written decoder (``cdr.DECODERS``) fall back to
    the schema-driven generic decoder (:mod:`.typesys`): pass a
    :class:`~bluerov2_dynamics_tpu_torch.data.typesys.TypeStore` with
    custom ``.msg``/``.idl`` registrations, or the PX4-preloaded default
    is used.
    """
    if tops is None:
        tops = topics_of(db3_path)
    if topic not in tops:
        return
    tid, typ = tops[topic]
    decoder = cdr.DECODERS.get(typ)
    if decoder is None:
        store = typestore if typestore is not None else _default_store()
        if typ in store.types:
            decoder = lambda blob: store.decode(typ, blob)  # noqa: E731
        else:
            warn(f"No CDR decoder or registered schema for type {typ!r} "
                 f"(topic {topic}); skipping.")
            return
    with sqlite3.connect(f"file:{Path(db3_path)}?mode=ro", uri=True) as con:
        cur = con.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id = ? "
            "ORDER BY timestamp", (tid,),
        )
        n_ok = n_fail = 0
        first_err = None
        for ts, blob in cur:
            try:
                msg = decoder(bytes(blob))
            except Exception as e:  # tolerate stray corrupt rows...
                n_fail += 1
                if first_err is None:
                    first_err = e
                continue
            n_ok += 1
            yield ts, msg
    # ...but a SYSTEMATIC decode failure (unregistered nested type, wrong
    # field layout) must not become a silently empty stream
    if n_fail and n_fail >= n_ok:
        warn(f"{topic}: {n_fail}/{n_ok + n_fail} messages failed to decode "
             f"as {typ!r} (first error: {first_err!r}) — schema mismatch?")


def read_bag_sqlite(
    bag_path,
    topics: BagTopics = BagTopics(),
    verbose: bool = True,
    use_native: bool = True,
) -> Tuple[tb.Table, Optional[tb.Table]]:
    """Drop-in equivalent of :func:`..bag2csv.read_bag` with no dependencies.

    Source priority and frame handling: mocap Odometry -> mocap Pose+Twist
    -> PX4 VehicleOdometry (NED->ENU).  With ``use_native`` the C++ batch
    CDR decoders (:mod:`.native_cdr`) process each topic in one call; a
    topic falls back to the per-message Python codec when they cannot be
    built or refuse a blob.
    """
    db3 = find_db3(bag_path)
    tops = topics_of(db3)
    if verbose:
        info(f"rosbag2 sqlite storage: {db3} ({len(tops)} topics)")
    t0 = None

    def rel(stamps):
        nonlocal t0
        stamps = np.asarray(stamps, np.int64)
        if t0 is None and len(stamps):
            t0 = int(stamps[0])
        return (stamps - (t0 or 0)) * 1e-9

    def native(fn, topic, blobs):
        if not use_native:
            ROUTES[(topic, "python")] += len(blobs)
            return None
        try:
            from bluerov2_dynamics_tpu_torch.data import native_cdr

            res = getattr(native_cdr, fn)(blobs)
        except Exception as e:
            if verbose:
                warn(f"native CDR decode unavailable ({e}); using Python codec")
            ROUTES[(topic, "python")] += len(blobs)
            return None
        ROUTES[(topic, "native")] += len(blobs)
        return res

    if topics.mocap_odom in tops:
        rows, _ = raw_messages(db3, topics.mocap_odom, tops=tops)
        times = rel([ts for ts, _ in rows])
        res = native("decode_odometry_batch", topics.mocap_odom, [b for _, b in rows])
        if res is not None:
            fields, flags = res
            pos = fields[:, 0:3]
            quats = fields[:, 3:7]
            lin = fields[:, 7:10]
            ang = fields[:, 10:13]
            mode = "body" if (len(flags) and flags[len(flags) // 2]) else None
        else:
            pos, quats, lin, ang, frames = [], [], [], [], []
            for _, blob in rows:
                m = cdr.decode_odometry(blob)
                p = m.pose.pose.position
                o = m.pose.pose.orientation
                tw = m.twist.twist
                pos.append((p.x, p.y, p.z))
                quats.append((o.x, o.y, o.z, o.w))
                lin.append((tw.linear.x, tw.linear.y, tw.linear.z))
                ang.append((tw.angular.x, tw.angular.y, tw.angular.z))
                frames.append(m.child_frame_id)
            mode = None
            if frames and any(frames):
                cf = frames[len(frames) // 2]
                if isinstance(cf, str) and any(k in cf for k in ("base_link", "body", "base")):
                    mode = "body"
        if mode is None:
            mode = infer_twist_frame(times, pos, lin, quats, verbose)
        df_odom = odom_table(times, pos, quats, lin, ang, mode)

    elif topics.mocap_pose in tops and topics.mocap_vel in tops:
        pose = list(iter_messages(db3, topics.mocap_pose, tops=tops))
        prow = [
            (t, m.pose.position.x, m.pose.position.y, m.pose.position.z,
             m.pose.orientation.x, m.pose.orientation.y, m.pose.orientation.z,
             m.pose.orientation.w)
            for t, (_, m) in zip(rel([ts for ts, _ in pose]).tolist(), pose)
        ]
        vel = list(iter_messages(db3, topics.mocap_vel, tops=tops))
        vrow = [
            (t, m.twist.linear.x, m.twist.linear.y, m.twist.linear.z,
             m.twist.angular.x, m.twist.angular.y, m.twist.angular.z)
            for t, (_, m) in zip(rel([ts for ts, _ in vel]).tolist(), vel)
        ]
        ROUTES[(topics.mocap_pose, "python")] += len(prow)
        ROUTES[(topics.mocap_vel, "python")] += len(vrow)
        df_odom = pose_twist_odometry(prow, vrow, verbose)

    elif topics.px4_odom in tops:
        raw, _ = raw_messages(db3, topics.px4_odom, tops=tops)
        times = rel([ts for ts, _ in raw])
        fields = native("decode_vehicle_odometry_batch", topics.px4_odom, [b for _, b in raw])
        if fields is None:
            decoded = [cdr.decode_vehicle_odometry(b) for _, b in raw]
            fields = np.asarray(
                [
                    (*m.position, *m.q, *m.velocity, *m.angular_velocity)
                    for m in decoded
                ],
                np.float64,
            )
        pos_ned = np.asarray(fields[:, 0:3], np.float64)
        q_wxyz = np.asarray(fields[:, 3:7], np.float64)
        q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
        pos = ned_to_enu(pos_ned)
        quats = ned_quat_to_enu(q_xyzw)
        lin = ned_to_enu(np.asarray(fields[:, 7:10], np.float64))
        ang = ned_to_enu(np.asarray(fields[:, 10:13], np.float64))
        df_odom = odom_table(times, pos, quats, lin, ang, mode="parent")

    else:
        raise RuntimeError(
            "No pose/odometry stream found in bag. Available topics: "
            f"{sorted(tops)}"
        )

    df_act = None
    if topics.px4_motors in tops:
        raw, _ = raw_messages(db3, topics.px4_motors, tops=tops)
        if raw:
            times = rel([ts for ts, _ in raw])
            controls = native("decode_actuator_motors_batch", topics.px4_motors,
                              [b for _, b in raw])
            if controls is None:
                controls = np.asarray(
                    [cdr.decode_actuator_motors(b).control[:8] for _, b in raw],
                    float,
                )
            controls = np.asarray(controls, float)
            actuator_diagnostics(controls, verbose)
            df_act = actuator_table(times, controls)
    elif verbose:
        info("Actuator topic not present.")

    return tb.sort_by(df_odom), df_act

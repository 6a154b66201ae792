"""Minimal CDR (Common Data Representation) codec for ROS 2 messages.

rosbag2 stores messages CDR-serialized (XCDR1): a 4-byte encapsulation
header (representation id + options) followed by the payload with
primitives aligned to their own size *relative to the payload start*.
This module implements just enough of the format to decode (and, for
tests, encode) the message types the BlueROV2 ingestion pipeline needs —
so :mod:`bag2csv` can run without the optional ``rosbags`` dependency
(see :mod:`bag_sqlite`).

Supported wire types: primitive scalars, fixed-size primitive arrays,
strings, and the specific nested layouts of nav_msgs/Odometry,
geometry_msgs/PoseStamped, geometry_msgs/TwistStamped,
px4_msgs/VehicleOdometry, px4_msgs/ActuatorMotors and
px4_msgs/SensorCombined.  Counterpart of
``bluerov2_dynamics_tpu/data/cdr.py``: the bytes written and the fields
decoded are the same.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace

_LE_HEADER = b"\x00\x01\x00\x00"  # CDR_LE representation identifier + options

_FMT = {
    "int8": ("b", 1), "uint8": ("B", 1), "bool": ("?", 1),
    "int16": ("h", 2), "uint16": ("H", 2),
    "int32": ("i", 4), "uint32": ("I", 4),
    "int64": ("q", 8), "uint64": ("Q", 8),
    "float32": ("f", 4), "float64": ("d", 8),
}


class CdrReader:
    """Alignment-aware little-endian CDR payload reader."""

    def __init__(self, data: bytes):
        if data[:2] not in (b"\x00\x01", b"\x00\x00"):
            raise ValueError("unsupported CDR encapsulation (expect XCDR1)")
        if data[:2] == b"\x00\x00":
            raise ValueError("big-endian CDR not supported")
        self.buf = data
        self.pos = 4  # skip encapsulation header

    def _align(self, size: int):
        # alignment is relative to the payload start (offset 4)
        rel = self.pos - 4
        pad = (-rel) % size
        self.pos += pad

    def prim(self, kind: str):
        fmt, size = _FMT[kind]
        self._align(size)
        (val,) = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return val

    def array(self, kind: str, n: int):
        fmt, size = _FMT[kind]
        self._align(size)
        vals = struct.unpack_from(f"<{n}{fmt}", self.buf, self.pos)
        self.pos += size * n
        return list(vals)

    def string(self) -> str:
        n = self.prim("uint32")  # length including NUL terminator
        raw = self.buf[self.pos : self.pos + n]
        self.pos += n
        return raw.rstrip(b"\x00").decode("utf-8", errors="replace")

    def wstring(self) -> str:
        # fastcdr wire format: uint32 length in UTF-16 code units (no
        # terminator), then n uint16 little-endian code units.  Decoding
        # this as a narrow string would advance pos by n instead of 2n and
        # silently misalign every subsequent field.
        n = self.prim("uint32")
        raw = self.buf[self.pos : self.pos + 2 * n]
        self.pos += 2 * n
        return raw.decode("utf-16-le", errors="replace")


class CdrWriter:
    """CDR payload writer (mirror of :class:`CdrReader`; used in tests and
    for synthesizing bags)."""

    def __init__(self):
        self.parts = bytearray(_LE_HEADER)

    def _align(self, size: int):
        rel = len(self.parts) - 4
        self.parts.extend(b"\x00" * ((-rel) % size))

    def prim(self, kind: str, val):
        fmt, size = _FMT[kind]
        self._align(size)
        self.parts.extend(struct.pack("<" + fmt, val))
        return self

    def array(self, kind: str, vals):
        fmt, size = _FMT[kind]
        self._align(size)
        self.parts.extend(struct.pack(f"<{len(vals)}{fmt}", *vals))
        return self

    def string(self, s: str):
        raw = s.encode("utf-8") + b"\x00"
        self.prim("uint32", len(raw))
        self.parts.extend(raw)
        return self

    def wstring(self, s: str):
        raw = s.encode("utf-16-le")
        self.prim("uint32", len(raw) // 2)  # length in UTF-16 code units
        self.parts.extend(raw)
        return self

    def bytes(self) -> bytes:
        return bytes(self.parts)


# --------------------------- common sub-structures ---------------------------

def _read_header(r: CdrReader):
    return SimpleNamespace(
        stamp=SimpleNamespace(sec=r.prim("int32"), nanosec=r.prim("uint32")),
        frame_id=r.string(),
    )


def _write_header(w: CdrWriter, sec=0, nanosec=0, frame_id="map"):
    w.prim("int32", sec).prim("uint32", nanosec).string(frame_id)


def _read_vec3(r: CdrReader):
    return SimpleNamespace(x=r.prim("float64"), y=r.prim("float64"), z=r.prim("float64"))


def _read_quat(r: CdrReader):
    return SimpleNamespace(
        x=r.prim("float64"), y=r.prim("float64"),
        z=r.prim("float64"), w=r.prim("float64"),
    )


def _read_pose(r: CdrReader):
    return SimpleNamespace(position=_read_vec3(r), orientation=_read_quat(r))


def _read_twist(r: CdrReader):
    return SimpleNamespace(linear=_read_vec3(r), angular=_read_vec3(r))


# --------------------------- message decoders ---------------------------

def decode_odometry(data: bytes):
    """nav_msgs/msg/Odometry."""
    r = CdrReader(data)
    header = _read_header(r)
    child_frame_id = r.string()
    pose = _read_pose(r)
    pose_cov = r.array("float64", 36)
    twist = _read_twist(r)
    twist_cov = r.array("float64", 36)
    return SimpleNamespace(
        header=header,
        child_frame_id=child_frame_id,
        pose=SimpleNamespace(pose=pose, covariance=pose_cov),
        twist=SimpleNamespace(twist=twist, covariance=twist_cov),
    )


def decode_pose_stamped(data: bytes):
    """geometry_msgs/msg/PoseStamped."""
    r = CdrReader(data)
    return SimpleNamespace(header=_read_header(r), pose=_read_pose(r))


def decode_twist_stamped(data: bytes):
    """geometry_msgs/msg/TwistStamped."""
    r = CdrReader(data)
    return SimpleNamespace(header=_read_header(r), twist=_read_twist(r))


def decode_vehicle_odometry(data: bytes):
    """px4_msgs/msg/VehicleOdometry (layout in data/px4_msgs.py)."""
    r = CdrReader(data)
    out = SimpleNamespace()
    out.timestamp = r.prim("uint64")
    out.timestamp_sample = r.prim("uint64")
    out.pose_frame = r.prim("uint8")
    out.position = r.array("float32", 3)
    out.q = r.array("float32", 4)
    out.velocity_frame = r.prim("uint8")
    out.velocity = r.array("float32", 3)
    out.angular_velocity = r.array("float32", 3)
    out.position_variance = r.array("float32", 3)
    out.orientation_variance = r.array("float32", 3)
    out.velocity_variance = r.array("float32", 3)
    out.reset_counter = r.prim("uint8")
    out.quality = r.prim("int8")
    return out


def decode_actuator_motors(data: bytes):
    """px4_msgs/msg/ActuatorMotors."""
    r = CdrReader(data)
    out = SimpleNamespace()
    out.timestamp = r.prim("uint64")
    out.timestamp_sample = r.prim("uint64")
    out.reversible_flags = r.prim("uint16")
    out.control = r.array("float32", 12)
    return out


def decode_sensor_combined(data: bytes):
    """px4_msgs/msg/SensorCombined."""
    r = CdrReader(data)
    out = SimpleNamespace()
    out.timestamp = r.prim("uint64")
    out.gyro_rad = r.array("float32", 3)
    out.gyro_integral_dt = r.prim("uint32")
    out.accelerometer_timestamp_relative = r.prim("int32")
    out.accelerometer_m_s2 = r.array("float32", 3)
    out.accelerometer_integral_dt = r.prim("uint32")
    out.accelerometer_clipping = r.prim("uint8")
    out.gyro_clipping = r.prim("uint8")
    out.accel_calibration_count = r.prim("uint8")
    out.gyro_calibration_count = r.prim("uint8")
    return out


DECODERS = {
    "nav_msgs/msg/Odometry": decode_odometry,
    "geometry_msgs/msg/PoseStamped": decode_pose_stamped,
    "geometry_msgs/msg/TwistStamped": decode_twist_stamped,
    "px4_msgs/msg/VehicleOdometry": decode_vehicle_odometry,
    "px4_msgs/msg/ActuatorMotors": decode_actuator_motors,
    "px4_msgs/msg/SensorCombined": decode_sensor_combined,
}


# --------------------------- encoders (tests / synthesis) ---------------------------

def encode_odometry(pos, quat_xyzw, lin, ang, child_frame_id="base_link",
                    sec=0, nanosec=0):
    w = CdrWriter()
    _write_header(w, sec, nanosec, "map")
    w.string(child_frame_id)
    for v in pos:
        w.prim("float64", float(v))
    for v in quat_xyzw:
        w.prim("float64", float(v))
    w.array("float64", [0.0] * 36)
    for v in list(lin) + list(ang):
        w.prim("float64", float(v))
    w.array("float64", [0.0] * 36)
    return w.bytes()


def encode_actuator_motors(control12, timestamp=0):
    w = CdrWriter()
    w.prim("uint64", timestamp).prim("uint64", timestamp)
    w.prim("uint16", 0)
    w.array("float32", [float(v) for v in control12])
    return w.bytes()


def encode_vehicle_odometry(pos, q_wxyz, vel, ang, timestamp=0,
                            pose_frame=1, velocity_frame=1):
    w = CdrWriter()
    w.prim("uint64", timestamp).prim("uint64", timestamp)
    w.prim("uint8", pose_frame)
    w.array("float32", [float(v) for v in pos])
    w.array("float32", [float(v) for v in q_wxyz])
    w.prim("uint8", velocity_frame)
    w.array("float32", [float(v) for v in vel])
    w.array("float32", [float(v) for v in ang])
    for _ in range(3):
        w.array("float32", [0.0, 0.0, 0.0])
    w.prim("uint8", 0).prim("int8", 0)
    return w.bytes()

"""The port's CDR codec (``data/cdr.py``), message definitions
(``data/px4_msgs.py``), schema decoder (``data/typesys.py``) and native
batch decoder (``data/native_cdr.py`` over its own ``native/cdr_decode.cpp``,
built here with ``g++``) against the JAX package's on the same messages.

Tolerance: none.  The encoders are held byte for byte, every decoder field
for field with ``==``, and the native decoders' arrays bit for bit against
the JAX package's native decoder and against the Python codec.
"""

import math
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from bluerov2_dynamics_tpu.data import cdr as jcdr
from bluerov2_dynamics_tpu.data import native_cdr as jnative
from bluerov2_dynamics_tpu.data import px4_msgs as jpx4
from bluerov2_dynamics_tpu.data import typesys as jts
from bluerov2_dynamics_tpu_torch.data import cdr as tcdr
from bluerov2_dynamics_tpu_torch.data import native_cdr as tnative
from bluerov2_dynamics_tpu_torch.data import px4_msgs as tpx4
from bluerov2_dynamics_tpu_torch.data import typesys as tts


def _messages(rng, n=64):
    """Each encoder's inputs: random fields, odd child frames (alignment),
    NaN and inf controls, the largest stamps."""
    frames = ["base_link", "odom", "", "b", "body_frd", "a" * 13]
    out = []
    for k in range(n):
        q = rng.normal(size=4)
        ctrl = list(rng.normal(size=12))
        ctrl[8:] = [math.nan] * 4
        if k % 5 == 0:
            ctrl[k % 8] = math.inf if k % 2 else math.nan
        out.append(dict(
            odom=dict(pos=rng.normal(size=3), quat_xyzw=q / np.linalg.norm(q),
                      lin=rng.normal(size=3), ang=rng.normal(size=3),
                      child_frame_id=frames[k % len(frames)],
                      sec=int(rng.integers(0, 2**31 - 1)), nanosec=int(rng.integers(0, 10**9))),
            motors=dict(control12=ctrl, timestamp=int(rng.integers(0, 2**63 - 1))),
            px4=dict(pos=rng.normal(size=3), q_wxyz=rng.normal(size=4), vel=rng.normal(size=3),
                     ang=rng.normal(size=3), timestamp=2**64 - 1 - k,
                     pose_frame=k % 3, velocity_frame=k % 4)))
    return out


ENCODERS = {"odom": "encode_odometry", "motors": "encode_actuator_motors",
            "px4": "encode_vehicle_odometry"}


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    msgs = _messages(rng)
    out = {kind: [getattr(tcdr, fn)(**m[kind]) for m in msgs] for kind, fn in ENCODERS.items()}
    return out, msgs


@pytest.mark.parametrize("kind", list(ENCODERS))
def test_encoders_are_byte_for_byte_the_jax_packages(kind, blobs):
    got, msgs = blobs
    want = [getattr(jcdr, ENCODERS[kind])(**m[kind]) for m in msgs]
    assert got[kind] == want


def test_writer_and_reader_primitives_match_jax():
    def write(mod):
        w = mod.CdrWriter()
        w.string("abc").prim("float64", 2.5).wstring("ωx").prim("uint8", 7)
        w.array("int16", [-3, 4, 5]).prim("uint64", 2**64 - 1).string("")
        w.array("float32", [1.5, -0.0])
        return w.bytes()

    data = write(tcdr)
    assert data == write(jcdr)
    reads = []
    for mod in (tcdr, jcdr):
        r = mod.CdrReader(data)
        reads.append([r.string(), r.prim("float64"), r.wstring(), r.prim("uint8"),
                      r.array("int16", 3), r.prim("uint64"), r.string(), r.array("float32", 2),
                      r.pos])
    assert reads[0] == reads[1]
    for mod in (tcdr, jcdr):
        with pytest.raises(ValueError, match="big-endian"):
            mod.CdrReader(b"\x00\x00\x00\x00")


def _ns(x):
    """A decoded message as plain data (SimpleNamespace -> dict)."""
    if isinstance(x, SimpleNamespace):
        return {k: _ns(v) for k, v in vars(x).items()}
    if isinstance(x, list):
        return [_ns(v) for v in x]
    return x


def _same(a, b):
    """``==`` that takes NaN for NaN, field for field."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b and type(a) is type(b)


def _stamped(mod, kind):
    w = mod.CdrWriter()
    w.prim("int32", 5).prim("uint32", 6).string("map_odd")
    vals = [0.5 * i - 1.0 for i in range(7 if kind == "pose" else 6)]
    for v in vals:
        w.prim("float64", v)
    return w.bytes()


def _sensor_combined(mod):
    w = mod.CdrWriter()
    w.prim("uint64", 99).array("float32", [0.1, -0.2, 0.3]).prim("uint32", 4000)
    w.prim("int32", -7).array("float32", [9.8, 0.0, -1.0]).prim("uint32", 4001)
    for v in (1, 2, 3, 4):
        w.prim("uint8", v)
    return w.bytes()


def test_every_decoder_matches_jax_field_for_field(blobs):
    got, _ = blobs
    assert sorted(tcdr.DECODERS) == sorted(jcdr.DECODERS)
    cases = {
        "nav_msgs/msg/Odometry": got["odom"],
        "px4_msgs/msg/ActuatorMotors": got["motors"],
        "px4_msgs/msg/VehicleOdometry": got["px4"],
        "geometry_msgs/msg/PoseStamped": [_stamped(tcdr, "pose")],
        "geometry_msgs/msg/TwistStamped": [_stamped(tcdr, "twist")],
        "px4_msgs/msg/SensorCombined": [_sensor_combined(tcdr)],
    }
    for typ, data in cases.items():
        for blob in data:
            _same(_ns(tcdr.DECODERS[typ](blob)), _ns(jcdr.DECODERS[typ](blob)))


ACTUATOR_MOTORS_IDL = """\
module px4_msgs {
  module msg {
    typedef float float__12[12];
    module ActuatorMotors_Constants {
      const uint32 MESSAGE_VERSION = 0;
    };
    @verbatim (language="comment", text="Motor control message (a {brace})")
    struct ActuatorMotors {
      uint64 timestamp;
      @unit (value="us")
      uint64 timestamp_sample;
      uint16 reversible_flags;
      float__12 control;
    };
  };
};
"""


def test_definitions_and_schemas_match_jax():
    assert tpx4.DEFINITIONS == jpx4.DEFINITIONS
    for typ, text in tpx4.DEFINITIONS.items():
        assert tts.parse_msg(text, typ) == jts.parse_msg(text, typ)
    assert tts.parse_idl(ACTUATOR_MOTORS_IDL) == jts.parse_idl(ACTUATOR_MOTORS_IDL)
    assert tts.default_typestore().types == jts.default_typestore().types


def test_typesys_generic_decoder_matches_jax(blobs):
    got, _ = blobs
    ts_t, ts_j = tts.default_typestore(), jts.default_typestore()
    for typ, data in (("px4_msgs/msg/ActuatorMotors", got["motors"]),
                      ("px4_msgs/msg/VehicleOdometry", got["px4"]),
                      ("px4_msgs/msg/SensorCombined", [_sensor_combined(tcdr)])):
        for blob in data:
            a = _ns(ts_t.decode(typ, blob))
            _same(a, _ns(ts_j.decode(typ, blob)))
            # the generic decoder reads what the hand-written one reads
            hand = _ns(tcdr.DECODERS[typ](blob))
            _same({k: a[k] for k in hand}, hand)
    # a nested type and a sequence, registered from .msg text
    for ts in (ts_t, ts_j):
        ts.register_msg("demo/msg/Pair", "float64 a\nuint8[] flags\n")
        ts.register_msg("demo/msg/Holder", "std_msgs/Header header\nPair[2] pairs\nstring name\n")
    w = tcdr.CdrWriter()
    w.prim("int32", 1).prim("uint32", 2).string("frame")
    for a, flags in ((1.5, [1, 2, 3]), (-2.0, [])):
        w.prim("float64", a).prim("uint32", len(flags)).array("uint8", flags)
    w.string("holder")
    blob = w.bytes()
    _same(_ns(ts_t.decode("demo/msg/Holder", blob)), _ns(ts_j.decode("demo/msg/Holder", blob)))


def test_native_matches_the_jax_native_and_the_python_codec(blobs):
    """One C call a topic, bit for bit with the JAX package's library and
    with the per-message Python decoders."""
    got, _ = blobs
    fields, flags = tnative.decode_odometry_batch(got["odom"])
    jf, jflags = jnative.decode_odometry_batch(got["odom"])
    np.testing.assert_array_equal(fields.view(np.int64), jf.view(np.int64))
    np.testing.assert_array_equal(flags, jflags)
    py = [tcdr.decode_odometry(b) for b in got["odom"]]
    want = np.array([[m.pose.pose.position.x, m.pose.pose.position.y, m.pose.pose.position.z,
                      m.pose.pose.orientation.x, m.pose.pose.orientation.y,
                      m.pose.pose.orientation.z, m.pose.pose.orientation.w,
                      m.twist.twist.linear.x, m.twist.twist.linear.y, m.twist.twist.linear.z,
                      m.twist.twist.angular.x, m.twist.twist.angular.y, m.twist.twist.angular.z]
                     for m in py])
    np.testing.assert_array_equal(fields.view(np.int64), want.view(np.int64))
    # the child-frame flag: "base" or "body" anywhere in the name
    np.testing.assert_array_equal(
        flags, [("base" in m.child_frame_id or "body" in m.child_frame_id) for m in py])

    motors = tnative.decode_actuator_motors_batch(got["motors"])
    np.testing.assert_array_equal(motors.view(np.int32),
                                  jnative.decode_actuator_motors_batch(got["motors"]).view(np.int32))
    want = np.array([tcdr.decode_actuator_motors(b).control[:8] for b in got["motors"]], np.float32)
    np.testing.assert_array_equal(motors.view(np.int32), want.view(np.int32))

    px4 = tnative.decode_vehicle_odometry_batch(got["px4"])
    np.testing.assert_array_equal(px4.view(np.int32),
                                  jnative.decode_vehicle_odometry_batch(got["px4"]).view(np.int32))
    want = np.array([(*m.position, *m.q, *m.velocity, *m.angular_velocity)
                     for m in (tcdr.decode_vehicle_odometry(b) for b in got["px4"])], np.float32)
    np.testing.assert_array_equal(px4.view(np.int32), want.view(np.int32))


def test_native_refuses_a_malformed_blob_as_jax_does(blobs):
    got, _ = blobs
    bad = got["motors"][:3] + [got["motors"][3][:25]] + got["motors"][4:6]
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="malformed ActuatorMotors blob at index 3"):
            mod.decode_actuator_motors_batch(bad)
    with pytest.raises(ValueError, match="index 0"):
        tnative.decode_odometry_batch([b"\x00\x00\x00\x00" + got["odom"][0][4:]])


def test_native_builds_under_build_and_never_beside_its_source():
    lib = tnative.library_path()
    assert tnative.available() and lib.exists()
    assert lib.parent == tnative.BUILD_DIR and lib.parent.parent.name == "build"
    src_dir = tnative._SRC.parent
    assert not list(src_dir.glob("*.so"))


def test_a_failed_build_raises_native_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-g++")
    with pytest.raises(tnative.NativeUnavailable, match="could not build cdr_decode"):
        tnative.decode_actuator_motors_batch([tcdr.encode_actuator_motors([0.0] * 12)])
    assert not tnative.available()
    assert not list((tmp_path / "native").glob("*.so"))


def test_motors_layout_is_the_hand_computed_one():
    """header(4) | u64 ts | u64 ts_sample | u16 flags | pad(2) | 12 f32."""
    control = [0.5] * 12
    expect = (b"\x00\x01\x00\x00" + struct.pack("<QQ", 7, 7) + struct.pack("<H", 0)
              + b"\x00\x00" + struct.pack("<12f", *control))
    assert tcdr.encode_actuator_motors(control, timestamp=7) == expect

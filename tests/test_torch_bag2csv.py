"""The port's host data path without pandas (``data/table.py``,
``bag2csv``, ``bag_sqlite``, ``bagmeta``, ``frames``, ``wrench.augment_csv``,
``sanity``, ``xlsx``, ``t200``) against the JAX package's pandas pipeline on
the same inputs: bags of a few hundred messages written here in rosbag2's
sqlite3 layout, adversarial timing for the resample and the joins, a
``metadata.yaml`` and a T200 workbook written here.

Tolerance: none.  Every table is compared bit for bit (NaN where NaN);
the CLI's CSV equals the JAX ``convert``'s byte for byte, and every CSV is
read back with pandas' default float parser on both sides (the port's
``table.read_csv`` reproduces it bit for bit) and compared bit for bit.
"""

import dataclasses
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from bluerov2_dynamics_tpu.data import bag2csv as jb  # noqa: E402
from bluerov2_dynamics_tpu.data import bag_sqlite as jsql  # noqa: E402
from bluerov2_dynamics_tpu.data import bagmeta as jmeta  # noqa: E402
from bluerov2_dynamics_tpu.data import frames as jframes  # noqa: E402
from bluerov2_dynamics_tpu.data import sanity as jsanity  # noqa: E402
from bluerov2_dynamics_tpu.data import t200 as jt200  # noqa: E402
from bluerov2_dynamics_tpu.data import wrench as jwrench  # noqa: E402
from bluerov2_dynamics_tpu.data.csv_loader import load_thruster_dataset as jload  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import bag2csv as tb2c  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import bag_sqlite as tsql  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import bagmeta as tmeta  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import cdr  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import frames as tframes  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import sanity as tsanity  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import t200 as tt200  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import table as tb  # noqa: E402
from bluerov2_dynamics_tpu_torch.data import wrench as twrench  # noqa: E402
from bluerov2_dynamics_tpu_torch.data.csv_loader import (  # noqa: E402
    euler_to_quat_np, load_thruster_dataset)

TOPICS = tb2c.BagTopics()
COLS = ["t"] + tb2c.STATE_COLS + tb2c.ACT_COLS
# the real recordings' topics and types (tests/test_bagmeta.py EXPECTED_TYPES)
REAL_TYPES = {
    "mocap_odom": "nav_msgs/msg/Odometry",
    "mocap_pose": "geometry_msgs/msg/PoseStamped",
    "mocap_vel": "geometry_msgs/msg/TwistStamped",
    "px4_odom": "px4_msgs/msg/VehicleOdometry",
    "px4_motors": "px4_msgs/msg/ActuatorMotors",
}


def _header(w):
    w.prim("int32", 0).prim("uint32", 0).string("map")


def _pose_stamped(pos, q_xyzw):
    w = cdr.CdrWriter()
    _header(w)
    for v in list(pos) + list(q_xyzw):
        w.prim("float64", float(v))
    return w.bytes()


def _twist_stamped(lin, ang):
    w = cdr.CdrWriter()
    _header(w)
    for v in list(lin) + list(ang):
        w.prim("float64", float(v))
    return w.bytes()


def make_bag(tmp_path, rng, source="odom", n=200, with_motors=True, name="bag", extra=()):
    """A rosbag2 directory: odometry from ``source`` ("odom" with a body
    child frame, "odom_parent" with a world twist, "pose_twist" or "px4")
    at ~100 Hz with jittered stamps off the 20 ms grid, and motors at half
    rate with the last 4 of 12 controls NaN and an occasional NaN channel;
    ``extra`` blobs are appended to the motors."""
    t = np.arange(n) * 0.01 + rng.uniform(0, 2e-4, n)
    stamps = 1_234_567_891 + np.round(t * 1e9).astype(np.int64)
    angles = np.stack([0.1 * np.sin(t), 0.05 * np.cos(t), 4.0 * t], axis=1)  # yaw wraps
    q_wxyz = euler_to_quat_np(angles[:, 0], angles[:, 1], angles[:, 2])
    q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    pos = np.stack([np.sin(t), np.cos(t), 0.1 * t], axis=1)
    lin, ang = rng.normal(size=(n, 3)) * 0.2, rng.normal(size=(n, 3)) * 0.1
    streams = {}
    if source in ("odom", "odom_parent"):
        frame = "base_link" if source == "odom" else "odom"
        streams[TOPICS.mocap_odom] = (REAL_TYPES["mocap_odom"], stamps, [
            cdr.encode_odometry(pos[k], q_xyzw[k], lin[k], ang[k], child_frame_id=frame)
            for k in range(n)])
    elif source == "pose_twist":
        streams[TOPICS.mocap_pose] = (REAL_TYPES["mocap_pose"], stamps, [
            _pose_stamped(pos[k], q_xyzw[k]) for k in range(n)])
        # the twist stream lags by 3 ms and drops every 7th message
        keep = [k for k in range(n) if k % 7]
        streams[TOPICS.mocap_vel] = (REAL_TYPES["mocap_vel"], stamps[keep] + 3_000_000, [
            _twist_stamped(lin[k], ang[k]) for k in keep])
    else:
        streams[TOPICS.px4_odom] = (REAL_TYPES["px4_odom"], stamps, [
            cdr.encode_vehicle_odometry(pos[k], q_wxyz[k], lin[k], ang[k], timestamp=k)
            for k in range(n)])
    motors = []
    for k in range(0, n if with_motors else 0, 2):
        ctrl = list(np.clip(rng.normal(size=8) * 0.6, -1.2, 1.2)) + [np.nan] * 4
        if k % 10 == 0:
            ctrl[k % 8] = np.nan
        motors.append((stamps[k] + 1_000_000, cdr.encode_actuator_motors(ctrl, timestamp=k)))
    motors += [(stamps[-1] + 1_000_000 * (i + 1), blob) for i, blob in enumerate(extra)]
    if motors:
        streams[TOPICS.px4_motors] = (REAL_TYPES["px4_motors"], [t for t, _ in motors],
                                      [b for _, b in motors])
    tsql.write_bag_sqlite(tmp_path / name, streams)
    return tmp_path / name


def same_table(got, want):
    """The port's table equals the JAX package's DataFrame, bit for bit."""
    assert list(got) == list(want.columns)
    for c in want.columns:
        a, b = np.asarray(got[c], np.float64), want[c].to_numpy(np.float64)
        assert a.shape == b.shape, c
        assert np.array_equal(a, b, equal_nan=True), (c, np.nanmax(np.abs(a - b)))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("source, motors", [
    ("odom", True), ("odom", False), ("odom_parent", True), ("pose_twist", True),
    ("px4", True), ("px4", False)])
def test_read_bag_sqlite_matches_jax(source, motors, native, tmp_path, rng):
    bag = make_bag(tmp_path, rng, source, with_motors=motors)
    tsql.ROUTES.clear()
    got_o, got_a = tsql.read_bag_sqlite(bag, verbose=False, use_native=native)
    want_o, want_a = jsql.read_bag_sqlite(bag, verbose=False, use_native=native)
    same_table(got_o, want_o)
    assert (got_a is None) == (want_a is None)
    if want_a is not None:
        same_table(got_a, want_a)
    # pose + twist go through the schema decoders, message by message
    route = "native" if native and source != "pose_twist" else "python"
    odom_topic = {"px4": TOPICS.px4_odom, "pose_twist": TOPICS.mocap_pose}.get(
        source, TOPICS.mocap_odom)
    want_routes = {(odom_topic, route): 200}
    if source == "pose_twist":
        want_routes[(TOPICS.mocap_vel, "python")] = 171
    if motors:
        want_routes[(TOPICS.px4_motors, "native" if native else "python")] = 100
    assert dict(tsql.ROUTES) == want_routes


def test_pose_twist_rotated_into_the_body_frame_matches_jax(tmp_path, capsys):
    """A pose + twist bag whose twists are inferred world-frame: the
    rotation into the body frame gives the JAX package's bits (the joined
    columns keep pandas' column-major layout, which sets numpy's
    reduction order in the quaternion's norm)."""
    bag = make_bag(tmp_path, np.random.default_rng(1), "pose_twist", n=300)
    got_o, _ = tsql.read_bag_sqlite(bag)
    want_o, _ = jsql.read_bag_sqlite(bag)
    assert capsys.readouterr().out.count("Twist frame inference: parent") == 2
    same_table(got_o, want_o)


def test_without_the_native_decoder_each_topic_takes_the_python_codec(tmp_path, rng,
                                                                     monkeypatch):
    """A failed native build: every topic falls back to the per-message
    codec (counted so) and the tables are the same bits."""
    from bluerov2_dynamics_tpu_torch.data import native_cdr

    bag = make_bag(tmp_path, rng, "odom", n=60)
    want = tsql.read_bag_sqlite(bag, verbose=False)

    def refuse():
        raise native_cdr.NativeUnavailable("no compiler")

    monkeypatch.setattr(native_cdr, "_load", refuse)
    tsql.ROUTES.clear()
    got = tsql.read_bag_sqlite(bag, verbose=False)
    assert dict(tsql.ROUTES) == {(TOPICS.mocap_odom, "python"): 60,
                                 (TOPICS.px4_motors, "python"): 30}
    for g, w in zip(got, want):
        same_table(g, pd.DataFrame(w))


def test_a_truncated_blob_is_refused_by_both_routes(tmp_path, rng):
    """The native decoder refuses a truncated blob; the topic then goes
    message by message, as in the JAX package, where the codec refuses it
    too."""
    blob = cdr.encode_actuator_motors([0.1] * 12)
    bag = make_bag(tmp_path, rng, "odom", n=40, with_motors=False, extra=[blob, blob[:20]])
    tsql.ROUTES.clear()
    for mod in (tsql, jsql):
        with pytest.raises(Exception, match="unpack"):
            mod.read_bag_sqlite(bag, verbose=False)
    assert tsql.ROUTES[(TOPICS.px4_motors, "python")] == 2


def test_iter_messages_warns_on_a_systematic_decode_failure(tmp_path, capsys):
    db3 = tsql.write_bag_sqlite(tmp_path / "bad", {
        "/x": ("px4_msgs/msg/SensorCombined", [0, 1, 2], [b"\x00\x01\x00\x00"] * 3)})
    for mod in (tsql, jsql):
        assert list(mod.iter_messages(db3, "/x")) == []
        assert "3/3 messages failed to decode" in capsys.readouterr().out


def _odom_frame(rng, t):
    d = {"t": np.asarray(t, float)}
    for c in tb2c.STATE_COLS:
        d[c] = rng.normal(size=len(t))
    return d


def _case(name, rng):
    """(df_odom, actuator (times, raw) or None, hz) of each adversarial case."""
    if name == "anchored_bins":
        d = _odom_frame(rng, [0.0013, 0.0113, 0.0213, 0.0313, 0.0713])
        d["x"] = np.arange(5.0)
        return d, None, 50.0
    t = np.sort(rng.uniform(0, 6, 500)) + 0.0037                  # a start off the grid
    if name == "gap":
        t = np.concatenate([t[:200], t[300:] + 0.5])              # a gap of many bins
    d = _odom_frame(rng, t)
    d["psi"] = np.cumsum(rng.normal(size=len(t)))                 # wraps: unwrapped first
    ta = np.sort(rng.uniform(0, 6.5, 200))
    raw = rng.uniform(-1.3, 1.3, (200, 8))
    hz = 50.0
    if name == "nan_motors":
        raw[rng.uniform(size=raw.shape) < 0.2] = np.nan
        ta = ta[50:]
        raw = raw[50:]                                            # leading rows unmatched
    if name == "inf_state":
        d["z"][[5, 77]] = [np.inf, -np.inf]
        d["u"][100:104] = np.nan                                  # an all-NaN bin
        d["phi"][300] = np.nan                                    # NaN through the unwrap
    if name == "ties_and_edges":
        # dyadic times: tol = 0.5 / 2 = 0.25; left keys 0, 0.5, 1.0, ...
        t = np.arange(0, 8.0, 0.125)
        d = _odom_frame(rng, t)
        ta = np.array([0.375, 0.375, 0.625, 1.25, 1.75, 2.5, 2.5, 3.9, 5.0, 5.25, 6.0])
        raw = rng.uniform(-1, 1, (len(ta), 8))
        hz = 2.0
    if name == "hz0":
        hz = 0
    if name == "no_motors":
        return d, None, hz
    return d, (ta, raw), hz


CASES = ["anchored_bins", "off_grid", "gap", "nan_motors", "inf_state", "ties_and_edges",
         "hz0", "no_motors"]


@pytest.mark.parametrize("case", CASES)
def test_resample_and_join_matches_pandas(case, rng):
    d, act, hz = _case(case, rng)
    jact = tact = None
    if act is not None:
        jact, tact = jb.actuator_table(*act), tb2c.actuator_table(*act)
        same_table(tact, jact)
    want = jb.resample_and_join(pd.DataFrame(d), jact, hz, verbose=False)
    got = tb2c.resample_and_join(d, tact, hz, verbose=False)
    assert list(got) == list(want.columns) == COLS
    same_table(got, want)
    if case == "anchored_bins":
        np.testing.assert_array_equal(got["x"], [0.5, 2.5, 3.25, 4.0])
        np.testing.assert_array_equal(got["t"], [0.0013, 0.0213, 0.0413, 0.0613])


def test_table_primitives_match_pandas(rng):
    """The pieces on their own: to_timedelta's rounding, Timedelta's
    truncation, merge_asof at ties and tolerance edges, sort order of
    ties, and drop_duplicates."""
    t = np.concatenate([rng.uniform(-5, 1000, 20000),
                        [1.6e-9, 2.5e-9, 0.5e-9, 3.5e-9, 0.0013, 916.58, -1.6e-9]])
    np.testing.assert_array_equal(tb.to_ns(t), pd.to_timedelta(t, unit="s").asi8)
    assert tb.to_ns([1.6e-9])[0] == 2
    for hz in (50, 30, 100, 7, 0.3, 47.3):
        assert tb.step_ns(hz) == pd.Timedelta(seconds=1.0 / hz).value
    left = np.arange(0, 4, 0.125)
    right = np.array([0.375, 0.375, 0.625, 1.25, 1.75, 2.5, 2.5, 3.0])
    for tol in (0.25, 0.125, 0.0625, 1e-9):
        want = pd.merge_asof(pd.DataFrame({"t": left}),
                             pd.DataFrame({"t": right, "i": np.arange(len(right))}),
                             on="t", direction="nearest", tolerance=tol)["i"]
        np.testing.assert_array_equal(tb.asof_nearest(left, right, tol),
                                      want.fillna(-1).to_numpy(np.int64))
    a = rng.integers(0, 20, 300).astype(float)
    a[[3, 40]] = np.nan
    np.testing.assert_array_equal(
        tb.sort_index(a), pd.DataFrame({"a": a}).sort_values("a").index.to_numpy())
    np.testing.assert_array_equal(
        tb.first_unique(a), pd.DataFrame({"a": a}).drop_duplicates("a").index.to_numpy())


def _read(path):
    return tb.read_csv(path)


@pytest.mark.parametrize("hz", ["50", "25"])
def test_cli_csv_equals_the_jax_convert(hz, tmp_path, rng):
    """``python -m ...bag2csv`` against the JAX package's ``convert`` on one
    bag: the same header, the same rows, the same float64 values."""
    bag = make_bag(tmp_path, rng, "odom", n=300)
    got = tb2c.main([str(bag), "--out", str(tmp_path / "port" / "ds"), "--hz", hz])
    want = jb.convert(bag, out_base=tmp_path / "jax" / "ds", hz=float(hz))
    assert got.name == want.name == "ds.csv"
    assert got.read_bytes() == want.read_bytes()
    same_table(_read(got), pd.read_csv(want))
    # the port's loaders read it as the JAX loaders read the JAX CSV
    ds_t, ds_j = load_thruster_dataset(got, verbose=False), jload(want, verbose=False)
    for f in ("X", "U", "t"):
        np.testing.assert_array_equal(getattr(ds_t, f), getattr(ds_j, f))


def test_cli_and_loader_run_with_pandas_blocked(tmp_path, rng, monkeypatch):
    bag = make_bag(tmp_path, rng, "px4", n=120)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    csv = tb2c.main([str(bag), "--out", str(tmp_path / "out" / "ds"), "--parquet"])
    assert not (tmp_path / "out" / "ds.parquet").exists()   # warned, not written
    ds = load_thruster_dataset(csv, verbose=False)
    assert ds.X.shape == (tb.nrows(_read(csv)), 12) and np.isfinite(ds.X).all()


def test_cli_video_and_parquet(tmp_path, rng):
    pytest.importorskip("pyarrow")
    bag = make_bag(tmp_path, rng, "odom", n=100)
    video = tmp_path / "out" / "quicklook.gif"
    csv = tb2c.main([str(bag), "--out", str(tmp_path / "out" / "ds"), "--parquet",
                     "--video", str(video)])
    assert video.read_bytes()[:6] in (b"GIF87a", b"GIF89a")
    jb.convert(bag, out_base=tmp_path / "jax" / "ds", write_parquet=True)
    same_table(pd.read_parquet(tmp_path / "out" / "ds.parquet"),
               pd.read_parquet(tmp_path / "jax" / "ds.parquet"))
    same_table(_read(csv), pd.read_csv(tmp_path / "jax" / "ds.csv"))


def _metadata_yaml(counts, duration_ns=916_580_000_000):
    topics = "".join(
        f"    - topic_metadata:\n"
        f"        name: {getattr(TOPICS, f)}\n"
        f"        type: {REAL_TYPES[f]}\n"
        f"        serialization_format: cdr\n"
        f"        offered_qos_profiles: \"- history: 3\\n  depth: 0\\n  reliability: 1\"\n"
        f"      message_count: {counts[f]}\n"
        for f in REAL_TYPES)
    return ("rosbag2_bagfile_information:\n"
            "  version: 5\n"
            "  storage_identifier: sqlite3\n"
            "  duration:\n"
            f"    nanoseconds: {duration_ns}\n"
            "  starting_time:\n"
            "    nanoseconds_since_epoch: 1762430000123456789\n"
            f"  message_count: {sum(counts.values())}\n"
            "  topics_with_message_count:\n" + topics +
            "  compression_format: \"\"\n"
            "  compression_mode: \"\"\n"
            "  relative_file_paths:\n"
            "    - bag_0.db3\n")


def test_bagmeta_and_validation_match_jax(tmp_path):
    """A ``metadata.yaml`` of the real recordings' layout: the same parse,
    and the same validation report (one topic under the 50 Hz target)."""
    counts = {"mocap_odom": 88_000, "mocap_pose": 88_100, "mocap_vel": 87_900,
              "px4_odom": 91_000, "px4_motors": 40_000}
    (tmp_path / "metadata.yaml").write_text(_metadata_yaml(counts))
    got, want = tmeta.read_metadata(tmp_path), jmeta.read_metadata(tmp_path)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.duration_s == 916.58 and len(got.topics) == 5
    (_, rep_t), (_, rep_j) = (tb2c.validate_against_metadata(tmp_path),
                              jb.validate_against_metadata(tmp_path))
    assert rep_t == rep_j
    assert all(rep_t[f]["found"] and rep_t[f]["decodable"] for f in REAL_TYPES)
    assert rep_t["px4_motors"]["issues"] and not rep_t["mocap_odom"]["issues"]


def test_frames_match_jax(tmp_path, rng):
    """The sign-convention scan on arrays and through the sqlite reader."""
    n = 300
    t = np.arange(n) * 0.02
    ang = np.stack([0.2 * np.sin(t), 0.1 * np.cos(t), 0.5 * t], axis=1)
    q_wxyz = euler_to_quat_np(ang[:, 0], ang[:, 1], ang[:, 2])
    q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    G = np.stack([np.sin(3 * t), np.cos(2 * t), np.sin(5 * t)], axis=1)
    # the mocap twist in the parent frame, its body rates flipped in y and z
    W = np.einsum("nji,nj->ni", tb2c.quat_dcm(q_xyzw), G * np.array([1, -1, -1]))
    tg = t + rng.uniform(-0.004, 0.004, n)
    args = (t, W, q_xyzw, tg, G + 0.05 * rng.normal(size=G.shape))
    assert tframes.score_conventions(*args, verbose=False) == \
        jframes.score_conventions(*args, verbose=False)
    stamps = 1_000_000 + np.arange(n) * 20_000_000
    bag = tmp_path / "frames"
    tsql.write_bag_sqlite(bag, {
        TOPICS.mocap_odom: (REAL_TYPES["mocap_odom"], stamps, [
            cdr.encode_odometry([0, 0, 0], q_xyzw[k], [0, 0, 0], W[k], child_frame_id="odom")
            for k in range(n)]),
        TOPICS.px4_odom: (REAL_TYPES["px4_odom"], stamps + 3_000, [
            cdr.encode_vehicle_odometry([0, 0, 0], [1, 0, 0, 0], [0, 0, 0], G[k])
            for k in range(n)])})
    got, want = tframes.compare_bag(bag), jframes.compare_bag(bag)
    assert got == want and got["rotated"]["flip"] == "flip_yz"


@pytest.mark.parametrize("names", ["u_cols", "fallback"])
def test_augment_csv_matches_jax(names, tmp_path, rng):
    n = 60
    cols = {"t": np.arange(n) * 0.02}
    for c in tb2c.STATE_COLS:
        cols[c] = rng.normal(size=n)
    for i in range(8):
        cols[f"u{i + 1}" if names == "u_cols" else f"cmd{i}"] = rng.uniform(-1, 1, n)
    cols["u3" if names == "u_cols" else "cmd2"][7] = np.nan
    src = tmp_path / "in.csv"
    pd.DataFrame(cols).to_csv(src, index=False)
    got = twrench.augment_csv(src, tmp_path / "port.csv", setpoint_names=names == "fallback")
    want = jwrench.augment_csv(src, tmp_path / "jax.csv", setpoint_names=names == "fallback")
    a = _read(got)
    b = pd.read_csv(want)
    assert list(a) == list(b.columns)
    same_table(a, b)


def test_augment_csv_keeps_only_numeric_columns(tmp_path, rng):
    src = tmp_path / "in.csv"
    df = pd.DataFrame({"t": [0.0, 0.02], "note": ["a", "b"],
                       **{f"u{i}": rng.uniform(-1, 1, 2) for i in range(1, 9)}})
    df.to_csv(src, index=False)
    out = _read(twrench.augment_csv(src, tmp_path / "o.csv"))
    assert list(out) == ["t", "Fx", "Fy", "Fz", "Mx", "My", "Mz"]


def test_sanity_matches_jax(tmp_path, rng):
    bag = make_bag(tmp_path, rng, "odom", n=400)
    csv = tb2c.main([str(bag), "--out", str(tmp_path / "ds")])
    ds = load_thruster_dataset(csv, verbose=False)
    got, want = tsanity.run_all(ds, verbose=False), jsanity.run_all(ds, verbose=False)
    assert got["kinematic"] == want["kinematic"] and got["buoyancy_drift"] == want["buoyancy_drift"]
    np.testing.assert_array_equal(got["actuator_corrs"], want["actuator_corrs"])


def _t200_workbook(path, rng):
    """A workbook with 16/18/20 V sheets of PWM and thrust (kgf), the
    layout ``t200.fit_from_xlsx`` discovers, a shared-string header and a
    non-numeric cell."""
    import zipfile

    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    sheets = ""
    rels = ""
    parts = {}
    for k, v in enumerate((16, 18, 20), start=1):
        sheets += f'<sheet name="{v} V" sheetId="{k}" r:id="rId{k}"/>'
        rels += (f'<Relationship Id="rId{k}" Type="x/worksheet" '
                 f'Target="worksheets/sheet{k}.xml"/>')
        pwm = np.arange(1100, 1901, 10)
        u = (pwm - 1500) / 400
        kgf = np.where(u >= 0, v / 16 * (3.7 * u + 1.1 * u**3), v / 16 * (2.9 * u + 0.8 * u**3))
        kgf = kgf + 0.01 * rng.normal(size=len(pwm))
        rows = '<row r="1"><c r="A1" t="s"><v>0</v></c><c r="B1" t="s"><v>1</v></c></row>'
        for i, (p, f) in enumerate(zip(pwm, kgf), start=2):
            cell = (f'<c r="B{i}"><v>{float(f)!r}</v></c>' if i != 5
                    else f'<c r="B{i}" t="s"><v>2</v></c>')          # "n/a"
            rows += f'<row r="{i}"><c r="A{i}"><v>{p}</v></c>{cell}</row>'
        parts[f"xl/worksheets/sheet{k}.xml"] = (
            f'<?xml version="1.0"?><worksheet {ns}><sheetData>{rows}</sheetData></worksheet>')
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/workbook.xml", (
            f'<?xml version="1.0"?><workbook {ns} xmlns:r="http://schemas.openxmlformats.org/'
            f'officeDocument/2006/relationships"><sheets>{sheets}</sheets></workbook>'))
        z.writestr("xl/_rels/workbook.xml.rels", (
            '<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.org/'
            f'package/2006/relationships">{rels}</Relationships>'))
        z.writestr("xl/sharedStrings.xml", (
            f'<?xml version="1.0"?><sst {ns}><si><t> PWM (µs)</t></si>'
            '<si><r><t>Force </t></r><r><t>(Kg f)</t></r></si><si><t>n/a</t></si></sst>'))
        for name, text in parts.items():
            z.writestr(name, text)


def test_xlsx_and_t200_match_jax(tmp_path, rng):
    from bluerov2_dynamics_tpu.data import xlsx as jx
    from bluerov2_dynamics_tpu_torch.data import xlsx as tx

    book = tmp_path / "t200.xlsx"
    _t200_workbook(book, rng)
    assert tx.sheet_names(book) == jx.sheet_names(book) == ["16 V", "18 V", "20 V"]
    assert tx.read_sheet(book, "18 V") == jx.read_sheet(book, "18 V")
    got, want = tt200.fit_from_xlsx(book), jt200.fit_from_xlsx(book)
    for v in (16, 18, 20):
        np.testing.assert_array_equal(got[v].pos_coeff, want[v].pos_coeff)
        np.testing.assert_array_equal(got[v].neg_coeff, want[v].neg_coeff)
    tt200.main([str(book), "--voltages", "16", "--plot-dir", str(tmp_path / "figs")])
    png = tmp_path / "figs" / "T200_16V_thrust_polynomial_fit.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert sorted(p.name for p in (tmp_path / "figs").iterdir()) == [png.name]

"""The host data path on the card's machine: the native CDR decoder built
there against the Python codec, and a small rosbag2 recording through
``bag2csv`` to a CSV that T2 reads on the card, its Fossen row on K2.

Every case needs a CUDA device and skips without one (the decoder and the
CSV path are the CPU tests' work here: ``test_torch_cdr.py``,
``test_torch_bag2csv.py``).  The file imports no JAX and no pandas: the
card's machine has no flax and no pandas.  Tolerances: the native decoder
equals the Python codec bit for bit; T2's Fossen row (K2 fused) against
its plain version at ``chip_smoke``'s rtol 1e-4 (its T2 row on the full
916.58 s bag measured 6.4e-8 on the H100).
"""

import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu_torch.data import bag2csv, bag_sqlite, cdr, native_cdr
from bluerov2_dynamics_tpu_torch.data.csv_loader import euler_to_quat_np


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 runs on the card")
    return torch.device("cuda")


def _bag(tmp_path, n=3000, seed=0):
    from bluerov2_dynamics_tpu_torch.data.synthetic import generate_tank_recording

    rec = generate_tank_recording(seed, n_steps=n, dt=0.01, device="cpu")
    X, U = rec.X.double().numpy(), rec.U.double().numpy()
    q = euler_to_quat_np(X[:, 3], X[:, 4], X[:, 5])
    q_xyzw = np.concatenate([q[:, 1:4], q[:, 0:1]], axis=1)
    rng = np.random.default_rng(seed)
    stamps = 1_700_000_000_003_000_000 + np.arange(n) * 10_000_000 + rng.integers(1, 4, n) * 10**6
    odom = [cdr.encode_odometry(x[0:3], qk, x[6:9], x[9:12], child_frame_id="base_link")
            for x, qk in zip(X, q_xyzw)]
    motors = [cdr.encode_actuator_motors(list(u) + [np.nan] * 4) for u in U]
    topics = bag2csv.BagTopics()
    bag_sqlite.write_bag_sqlite(tmp_path / "bag", {
        topics.mocap_odom: ("nav_msgs/msg/Odometry", stamps, odom),
        topics.px4_motors: ("px4_msgs/msg/ActuatorMotors", stamps, motors)})
    return tmp_path / "bag", odom, motors


@pytest.mark.cuda
def test_native_decoder_equals_the_python_codec_on_the_cards_machine(tmp_path, cuda):
    _, odom, motors = _bag(tmp_path, n=500)
    fields, flags = native_cdr.decode_odometry_batch(odom)
    py = [cdr.decode_odometry(b) for b in odom]
    want = np.array([[m.pose.pose.position.x, m.pose.pose.position.y, m.pose.pose.position.z,
                      m.pose.pose.orientation.x, m.pose.pose.orientation.y,
                      m.pose.pose.orientation.z, m.pose.pose.orientation.w,
                      m.twist.twist.linear.x, m.twist.twist.linear.y, m.twist.twist.linear.z,
                      m.twist.twist.angular.x, m.twist.twist.angular.y, m.twist.twist.angular.z]
                     for m in py])
    assert np.array_equal(fields.view(np.int64), want.view(np.int64)) and flags.all()
    got = native_cdr.decode_actuator_motors_batch(motors)
    want = np.array([cdr.decode_actuator_motors(b).control[:8] for b in motors], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
def test_bag_to_csv_to_t2_on_the_card_launches_k2(tmp_path, cuda, monkeypatch):
    import sys

    from bluerov2_dynamics_tpu_torch.apps import common, tank_koopman
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce

    bag, _, _ = _bag(tmp_path)
    monkeypatch.setitem(sys.modules, "pandas", None)
    bag_sqlite.ROUTES.clear()
    csv = bag2csv.main([str(bag), "--out", str(tmp_path / "ds")])
    assert {r for _, r in bag_sqlite.ROUTES} == {"native"}
    _build.reset_launch_counts()
    out = tank_koopman.main(["--csv", str(csv), "--physics-baseline", "--no-media",
                             "--n-rbfs", "32"], device=cuda)
    torch.cuda.synchronize()
    assert _build.launches["window_sq"] == 6
    from bluerov2_dynamics_tpu_torch.data.csv_loader import load_thruster_dataset

    dt = load_thruster_dataset(csv, verbose=False).dt       # the app's dt
    X = torch.as_tensor(out["test"].X, dtype=torch.float32, device=cuda)
    U = torch.as_tensor(out["test"].U, dtype=torch.float32, device=cuda)
    p, cfg, lag = fossen_params(device=cuda), thruster_config(device=cuda), lag_params(dt, device=cuda)
    for H in (1, 10, 100):
        want = float(common.fused_rmse(
            lambda X_, U_: ce.window_sq_plain(p, cfg, lag, X_, U_, dt, H, "euler"), X, U, H))
        got = out["rmse"]["Fossen (BlueROV2)"][H]
        assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (H, got, want)

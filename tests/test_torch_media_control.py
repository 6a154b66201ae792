"""The estimate and control apps run on the CPU without ``--no-media``
(``control_demo`` with ``--media-dir``), at cut sizes: each writes into a
temporary media directory exactly the figures the JAX app writes there
(``bluerov2_dynamics_tpu/apps/estimate.py``'s ``_save_figure`` names,
``control_demo.py``'s task names), each a PNG by its signature.  The LOS
figure's acceptance circles stay at the JAX app's fixed 0.15 m whatever
radius the mission flew with.
"""

import functools

import pytest

pytest.importorskip("matplotlib")

from bluerov2_dynamics_tpu_torch.apps import control_demo, estimate  # noqa: E402

PNG = b"\x89PNG\r\n\x1a\n"


def pngs(media):
    names = sorted(p.name for p in media.iterdir())
    assert all((media / n).read_bytes()[:8] == PNG for n in names), names
    return names


def test_estimate_writes_the_jax_apps_figures(tmp_path):
    media = tmp_path / "media"
    base = ["--synthetic", "--recording", "--media-dir", str(media)]
    estimate.main(base + ["--steps", "200", "--smooth"], device="cpu")
    estimate.main(base + ["--steps", "150", "--measure", "pose"], device="cpu")
    estimate.main(base + ["--steps", "150", "--contract", "quat"], device="cpu")
    assert pngs(media) == ["estimate_channels.png", "estimate_channels_pose.png",
                           "estimate_quat_channels.png"]


def test_control_demo_writes_each_tasks_figure(tmp_path, monkeypatch):
    """``all`` and two single tasks, at the cut sizes of
    ``tests/test_torch_control_app.py``."""
    for name, kw in (("run_waypoint", dict(horizon=30, opt_steps=10)),
                     ("run_koopman", dict(n_episodes=4, ep_len=50, n_rbfs=16)),
                     ("run_los", dict(steps=300)), ("run_ilqr", dict(horizon=30, iters=2))):
        monkeypatch.setattr(control_demo, name,
                            functools.partial(getattr(control_demo, name), **kw))
    media = tmp_path / "media"
    for task in ("all", "los", "ilqr"):
        out = control_demo.main([task, "--steps", "100", "--media-dir", str(media)],
                                device="cpu")
    assert set(out) == {"ilqr"}
    assert pngs(media) == ["control_demo_2D.png", "control_demo_ilqr_2D.png",
                           "control_demo_los_2D.png"]


def test_the_los_figure_keeps_its_circles_at_0_15(tmp_path, monkeypatch):
    from bluerov2_dynamics_tpu_torch import viz

    seen = {}
    monkeypatch.setattr(viz, "plot_topdown_with_depth",
                        lambda trajs, **kw: seen.update(kw) or kw["save_path"])
    los = control_demo.run_los(steps=50, accept_radius=0.4, device="cpu")
    path = control_demo.save_figure("los", {"los": los}, str(tmp_path))
    assert path.endswith("control_demo_los_2D.png")
    assert seen["obstacles"] == [(wx, wy, 0.15) for wx, wy, _ in control_demo.LOS_WAYPOINTS]
    assert control_demo.LOS_FIGURE_RADIUS == 0.15

"""The port's figures and animations (``viz/plots.py``, ``viz/animate.py``)
against the JAX package's on the same arrays.

Tolerance: none.  Each figure is decoded to its pixels and compared
pixel for pixel (every frame of the GIF, after PIL's decode); the port's
blitted frames are held against a full redraw of the same figure.
"""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
Image = pytest.importorskip("PIL.Image")

from bluerov2_dynamics_tpu.viz import animate as janim  # noqa: E402
from bluerov2_dynamics_tpu.viz import plots as jplots  # noqa: E402
from bluerov2_dynamics_tpu_torch.viz import animate as tanim  # noqa: E402
from bluerov2_dynamics_tpu_torch.viz import plots as tplots  # noqa: E402


def _trajs(T=60, n_models=3, quat=False, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * np.pi, T)
    out = {}
    for m in range(n_models):
        traj = np.zeros((T, 13 if quat else 12))
        traj[:, 0] = np.cos(t + 0.3 * m)
        traj[:, 1] = np.sin(2 * t + 0.1 * m)
        traj[:, 2] = -1.0 + 0.001 * rng.standard_normal(T).cumsum()
        yaw = np.unwrap(np.arctan2(np.gradient(traj[:, 1]), np.gradient(traj[:, 0])))
        if quat:
            traj[:, 3], traj[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
        else:
            traj[:, 5] = yaw
        out[f"model {m}"] = traj
    return out


def _pixels(path):
    with Image.open(path) as im:
        frames = []
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGBA")))
    return frames


def _same_pixels(a, b):
    fa, fb = _pixels(a), _pixels(b)
    assert len(fa) == len(fb)
    for k, (x, y) in enumerate(zip(fa, fb)):
        assert x.shape == y.shape, k
        assert np.count_nonzero(np.any(x != y, axis=-1)) == 0, f"frame {k}"
    return len(fa)


@pytest.mark.parametrize("quat", [False, True], ids=["euler12", "quat13"])
def test_topdown_with_depth_is_pixel_identical(quat, tmp_path):
    trajs = _trajs(T=200, quat=quat)
    kw = dict(dt=0.05, seconds=8.0, dpi=80, title="top view",
              obstacles=[(0.5, 0.0, 0.3), (-0.4, 0.4, 0.15)])
    got = tplots.plot_topdown_with_depth(trajs, save_path=str(tmp_path / "p.png"), **kw)
    want = jplots.plot_topdown_with_depth(trajs, save_path=str(tmp_path / "j.png"), **kw)
    assert got.endswith("p.png") and want.endswith("j.png")
    _same_pixels(got, want)
    short = {"a": trajs["model 0"][:1]}
    assert tplots.plot_topdown_with_depth(short, dt=0.05, seconds=8.0,
                                          save_path=str(tmp_path / "s.png")) is None


def test_coefficient_scales_is_pixel_identical(tmp_path):
    rng = np.random.default_rng(3)
    names = [f"c{i}" for i in range(23)]
    fitted = np.exp(0.1 * rng.normal(size=23))
    stderr = np.abs(rng.normal(size=23)) * 0.05
    stderr[[12, 14, 16]] = np.inf                   # the unidentifiable scales
    truth = 1 + rng.uniform(-0.1, 0.1, 23)
    kw = dict(true_scales=truth, stderr=stderr, dpi=60)
    got = tplots.plot_coefficient_scales(fitted, names, save_path=str(tmp_path / "p.png"), **kw)
    want = jplots.plot_coefficient_scales(fitted, names, save_path=str(tmp_path / "j.png"), **kw)
    _same_pixels(got, want)


def test_animate_topdown_is_pixel_identical(tmp_path):
    """60 frames, 3 panels: the same GIF, frame for frame; and above 50
    fps the same frames are dropped (120 fps -> every 3rd frame)."""
    trajs = _trajs(T=60)
    for speed, frames in ((1.0, 60), (12.0, 20)):
        paths = [tmp_path / f"{who}{speed}.gif" for who in ("p", "j")]
        for mod, path in zip((tanim, janim), paths):
            assert mod.animate_topdown(trajs, dt=0.1, save_path=str(path), title="t",
                                       speed=speed, dpi=50) is None
        assert _same_pixels(*paths) == frames


def test_blit_matches_a_full_redraw():
    import matplotlib.pyplot as plt

    for trajs in (_trajs(), _trajs(T=20, n_models=1, quat=True)):
        tf = tanim._TopdownFigure(trajs, dt=0.1, title="t", tail_secs=2.0, dpi=50, ncols=None)
        try:
            background = tf.snapshot_background()
            for i in (0, 7, tf.T - 1):
                blit = tf.render_frame_blit(i, background)
                tf.update(i)
                tf.fig.canvas.draw()
                full = np.asarray(tf.fig.canvas.buffer_rgba())
                assert np.array_equal(blit, full), i
        finally:
            plt.close(tf.fig)


def test_importing_the_port_imports_no_plotting_library():
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = (f"import sys; sys.path.insert(0, {str(repo)!r})\n"
            "import bluerov2_dynamics_tpu_torch.viz\n"
            "import bluerov2_dynamics_tpu_torch.apps.tank_full_comparison\n"
            "print(sorted(m for m in ('matplotlib', 'PIL') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The tank and simulation apps (T1-T6) run on the CPU without
``--no-media``, at cut sizes (the estimate and control apps:
``tests/test_torch_media_control.py``): each
writes into a temporary ``--media-dir`` exactly the files the JAX app
writes there (names from the JAX apps' media branches, e.g.
``bluerov2_dynamics_tpu/apps/tank_full_comparison.py``'s), each a PNG or a
GIF by its signature, each GIF with the frames its open-loop window
implies (``animate_topdown`` drops none below 50 fps).  The figures
themselves are held pixel for pixel against the JAX package's in
``tests/test_torch_viz.py``.
"""

import numpy as np
import pytest

pytest.importorskip("matplotlib")
Image = pytest.importorskip("PIL.Image")

from bluerov2_dynamics_tpu_torch.apps import (  # noqa: E402
    sim_koopman, tank_full_comparison, tank_koopman, tank_rk4, tank_wrench_comp,
    tank_wrench_quat)

PNG, GIF = b"\x89PNG\r\n\x1a\n", (b"GIF87a", b"GIF89a")
OPEN_LOOP = ["--open-loop-steps", "20"]


def written(media, **frames):
    """The files in ``media``, each checked by its signature; ``frames``
    maps a GIF's name (dots as underscores) to its frame count."""
    names = sorted(p.name for p in media.iterdir())
    for name in names:
        data = (media / name).read_bytes()
        if name.endswith(".png"):
            assert data[:8] == PNG, name
        else:
            assert name.endswith(".gif") and data[:6] in GIF, name
            with Image.open(media / name) as im:
                assert im.n_frames == frames[name.replace(".", "_")], name
    return names


def test_t1_and_t2_write_their_gifs(tmp_path):
    media = tmp_path / "media"
    sim_koopman.main(["--steps", "300", "--n-rbfs", "16", "--demo-steps", "20",
                      "--media-dir", str(media)], device="cpu")
    tank_koopman.main(["--synthetic", "--recording", "--steps", "400", "--n-rbfs", "16",
                       *OPEN_LOOP, "--media-dir", str(media)], device="cpu")
    assert written(media, sim_true_vs_koopman_gif=21, tank_true_vs_koopman_gif=21) == [
        "sim_true_vs_koopman.gif", "tank_true_vs_koopman.gif"]


def test_t3_and_t4_write_their_gifs(tmp_path):
    media = tmp_path / "media"
    for main in (tank_wrench_comp.main, tank_wrench_quat.main):
        main(["--synthetic", "--steps", "400", "--n-rbfs", "8", *OPEN_LOOP,
              "--media-dir", str(media)], device="cpu")
    assert written(media, tank_wrench_comparison_gif=21,
                   tank_wrench_quat_comparison_gif=21) == [
        "tank_wrench_comparison.gif", "tank_wrench_quat_comparison.gif"]


def test_t6_and_t5_write_their_figures(tmp_path, monkeypatch):
    """T6 with the Fossen fit draws the GIF, the 2-D figure and the fitted
    scales (their truth: the port's generator draws for the seed); T5 the
    first two under its ``rk4_`` prefix."""
    from bluerov2_dynamics_tpu_torch import viz
    from bluerov2_dynamics_tpu_torch.data.synthetic import recording_coefficient_draws

    seen = {}
    real = viz.plot_coefficient_scales

    def spy(fitted, names, true_scales=None, stderr=None, **kw):
        seen.update(fitted=fitted, true_scales=true_scales, names=list(names))
        return real(fitted, names, true_scales=true_scales, stderr=stderr, dpi=40, **kw)

    monkeypatch.setattr(viz, "plot_coefficient_scales", spy)
    media = tmp_path / "media"
    small = ["--synthetic", "--recording", "--steps", "600", "--n-rbfs", "16", "--pinc-epochs",
             "1", "--pinc-hidden", "16", "16", "--pinc-ckpt", str(tmp_path / "ck.msgpack"),
             *OPEN_LOOP, "--media-dir", str(media), "--seed", "3"]
    out = tank_full_comparison.main(small + ["--fossen-fit", "--fossen-fit-steps", "3"],
                                    device="cpu")
    tank_rk4.main(small, device="cpu")
    assert written(media, tank_true_vs_4models_gif=21, rk4_tank_true_vs_4models_gif=21) == [
        "fossen_fit_scales.png", "rk4_tank_true_vs_4models.gif",
        "rk4_tank_true_vs_4models_2D.png", "tank_true_vs_4models.gif",
        "tank_true_vs_4models_2D.png"]
    np.testing.assert_array_equal(seen["true_scales"], recording_coefficient_draws(3, 0.10))
    np.testing.assert_array_equal(seen["fitted"],
                                  np.exp(out["sysid"].log_scales.double().numpy()))
    assert len(seen["names"]) == 23

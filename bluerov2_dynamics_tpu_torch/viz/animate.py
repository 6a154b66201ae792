"""Top-view trajectory animations (host-side matplotlib).

One generic N-panel animator replacing the reference's per-script copies
(``animate_xy_true_vs_koopman`` / ``_four`` / ``_five``,
e.g. ``train_tank_brov2_full_comparison.py:120-254``): each trajectory gets
its own panel with a trailing path (TAIL_SECS window, as in the bag
quicklook video ``rosbags/bag2csv.py:483-559``), current-position dot,
heading arrow (FancyArrowPatch ``-|>``, matching the reference's panels)
and time/depth readout; axes are shared across panels.  Heading is read
from Euler yaw (column 5 of a 12-state trajectory) or derived from the
quaternion block of a 13-state trajectory.

GIF saving renders frames by MANUAL BLITTING + direct PIL assembly instead
of ``FuncAnimation.save``: matplotlib's writers redraw the full figure
(axes, grids, labels) for every frame, which measured ~15 minutes for a
500-frame 6-panel GIF.  Here the static background is rasterised
once, each frame restores it and redraws only the ~5 dynamic artists per
panel, and the RGBA buffer is handed to PIL; a 500-frame GIF renders in
seconds.  Frame-for-frame pixel equality with a full redraw is pinned by
``tests/test_torch_viz.py``.  Counterpart of
``bluerov2_dynamics_tpu/viz/animate.py``; matplotlib and PIL are imported
inside the functions, so importing the port imports neither.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _yaw_of(traj: np.ndarray) -> np.ndarray:
    """Yaw series from a (T, 12) Euler or (T, 13) quaternion trajectory."""
    if traj.shape[1] >= 13:  # quat13: [x,y,z,qw,qx,qy,qz,...]
        qw, qx, qy, qz = traj[:, 3], traj[:, 4], traj[:, 5], traj[:, 6]
        return np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy**2 + qz**2))
    return traj[:, 5]


class _TopdownFigure:
    """Shared figure/artist setup for the interactive and fast-save paths."""

    def __init__(self, trajs: Dict[str, np.ndarray], dt: float, title: str,
                 tail_secs: float, dpi: int, ncols: Optional[int]):
        import matplotlib.pyplot as plt
        from matplotlib.patches import FancyArrowPatch

        names = list(trajs)
        arrays = [np.asarray(trajs[n]) for n in names]
        T = arrays[0].shape[0]
        assert all(a.shape[0] == T for a in arrays), \
            "trajectories must share length"
        self.T, self.dt = T, dt

        n_panels = len(arrays)
        if ncols is None:
            ncols = min(3, n_panels)
        nrows = -(-n_panels // ncols)

        xs = np.concatenate([a[:, 0] for a in arrays])
        ys = np.concatenate([a[:, 1] for a in arrays])
        pad = lambda lo, hi: 0.10 * max(1e-6, hi - lo)  # noqa: E731
        xlim = (xs.min() - pad(xs.min(), xs.max()),
                xs.max() + pad(xs.min(), xs.max()))
        ylim = (ys.min() - pad(ys.min(), ys.max()),
                ys.max() + pad(ys.min(), ys.max()))
        self.head_len = 0.1 * max(xs.max() - xs.min(), ys.max() - ys.min(),
                                  1e-6)
        self.tail = max(1, int(tail_secs / max(dt, 1e-9)))

        self.fig, axes = plt.subplots(
            nrows, ncols, figsize=(4.7 * ncols, 4.0 * nrows), dpi=dpi,
            constrained_layout=True, squeeze=False,
        )
        self.fig.suptitle(title)
        flat_axes = axes.ravel()
        for ax in flat_axes[n_panels:]:
            ax.axis("off")

        self.panels = []
        for i, (name, a) in enumerate(zip(names, arrays)):
            ax = flat_axes[i]
            color = f"C{i}"
            ax.set_aspect("equal", adjustable="box")
            ax.set_xlim(*xlim)
            ax.set_ylim(*ylim)
            ax.grid(True, alpha=0.3)
            ax.set_xlabel("x [m]")
            ax.set_ylabel("y [m]")
            ax.set_title(name)
            # Dynamic artists sit ABOVE the spines (zorder 2.5): blitting
            # always paints them over the static raster, so their zorder
            # must say the same thing or a full redraw (and the pixel-parity
            # test) would tuck them under the axes frame.
            (path_line,) = ax.plot([], [], lw=2, alpha=0.9, color=color,
                                   zorder=3)
            (dot,) = ax.plot([], [], "o", ms=6, color=color, zorder=3)
            arrow = FancyArrowPatch((0, 0), (0, 0), arrowstyle="-|>",
                                    mutation_scale=12, lw=2, color=color,
                                    zorder=5)
            ax.add_patch(arrow)
            text = ax.text(0.02, 0.98, "", transform=ax.transAxes, va="top")
            self.panels.append((ax, a, _yaw_of(a), path_line, dot, arrow,
                                text))

        # Settle constrained_layout once, then freeze it: the layout engine
        # otherwise keeps nudging geometry on every draw, which would make
        # the blitted background raster drift out of sync with full redraws
        # (tests pin blit == full-redraw pixel equality).
        self.fig.canvas.draw()
        self.fig.set_layout_engine("none")

    def update(self, i: int):
        """Move the dynamic artists to frame ``i``; returns them."""
        out = []
        s = max(0, i - self.tail)
        for ax, a, yaw, path_line, dot, arrow, text in self.panels:
            path_line.set_data(a[s: i + 1, 0], a[s: i + 1, 1])
            dot.set_data([a[i, 0]], [a[i, 1]])
            x0, y0 = a[i, 0], a[i, 1]
            arrow.set_positions(
                (x0, y0),
                (x0 + self.head_len * math.cos(yaw[i]),
                 y0 + self.head_len * math.sin(yaw[i])),
            )
            text.set_text(f"t = {i * self.dt:5.2f} s\nz = {a[i, 2]:.2f} m")
            out.extend([path_line, dot, arrow, text])
        return out

    def render_frame_blit(self, i: int, background) -> np.ndarray:
        """Frame ``i`` as an (H, W, 4) RGBA array by restoring the static
        background and redrawing only the dynamic artists."""
        canvas = self.fig.canvas
        canvas.restore_region(background)
        artists = self.update(i)
        for ax, *_ in self.panels:
            # Paint in zorder like a full redraw does (the arrow at zorder 5
            # must cover the readout text at 3) — pinned pixel-identical to
            # a full-figure draw by tests/test_torch_viz.py.
            mine = [art for art in artists if art.axes is ax]
            for artist in sorted(mine, key=lambda art: art.get_zorder()):
                ax.draw_artist(artist)
        canvas.blit(self.fig.bbox)
        return np.asarray(canvas.buffer_rgba()).copy()

    def snapshot_background(self):
        """Rasterise the figure with the dynamic artists hidden; returns
        the region to restore per frame."""
        artists = self.update(0)
        for artist in artists:
            artist.set_visible(False)
        self.fig.canvas.draw()
        background = self.fig.canvas.copy_from_bbox(self.fig.bbox)
        for artist in artists:
            artist.set_visible(True)
        return background


def _save_gif_fast(tf: _TopdownFigure, save_path, fps: int,
                   frame_step: int = 1) -> None:
    """Render every frame by manual blitting and write the GIF with PIL.

    Encoding, in order of what it buys:

    - all frames share ONE 255-colour palette (median cut on the first
      frame, which already shows every panel colour + the background);
    - unchanged pixels are rewritten to a reserved transparent index with
      ``disposal=1`` (keep previous frame), so every frame after the first
      stores only its *changed* pixels — the same delta encoding PIL's
      ``optimize=True`` derives, minus its ~80 s analysis pass.  A
      round-trip decode is pinned pixel-identical in tests/test_torch_viz.py.
    """
    import numpy as np
    from PIL import Image

    background = tf.snapshot_background()
    TRANS = 255  # palette has 255 real colours; index 255 is the delta key
    # Streaming: quantize each frame as it is rendered and delta it
    # against only the previous index array, so the full-resolution RGB
    # buffers never accumulate (a 500-frame 6-panel GIF would otherwise
    # hold ~5 GB of RGBA/RGB/index copies at once); only the palettized
    # output frames — 1 byte/px — stay alive for the final save.
    base = palette = prev = None
    out = []
    for i in range(0, tf.T, frame_step):
        rgba = tf.render_frame_blit(i, background)
        frame = Image.fromarray(rgba[..., :3])
        if base is None:
            # median cut on the first frame, which already shows every
            # panel colour + the background
            base = frame.quantize(colors=255, method=Image.Quantize.MEDIANCUT)
            palette = base.getpalette()
        q = frame.quantize(palette=base, dither=Image.Dither.NONE)
        a = np.asarray(q)
        if prev is None:
            out.append(q)
        else:
            d = a.copy()
            d[a == prev] = TRANS
            im = Image.fromarray(d, mode="P")
            im.putpalette(palette)
            out.append(im)
        prev = a
    duration_ms = max(int(round(1000.0 * frame_step / max(fps, 1))), 20)
    out[0].save(
        save_path, save_all=True, append_images=out[1:],
        duration=duration_ms, loop=0, optimize=False,
        transparency=TRANS, disposal=1,
    )


def animate_topdown(
    trajs: Dict[str, np.ndarray],
    dt: float,
    save_path: Optional[str] = None,
    title: str = "Top view",
    tail_secs: float = 10.0,
    speed: float = 1.0,
    dpi: int = 120,
    ncols: Optional[int] = None,
):
    """Animate any number of equal-length trajectories, one panel each.

    ``trajs``: ordered mapping name -> (T, >=6) array.  Saves GIF (manual
    blit + PIL; seconds instead of the ~15 min matplotlib's PillowWriter
    took) or MP4 (ffmpeg) depending on the suffix; shows interactively
    when ``save_path`` is None; falls back to showing if saving fails
    (same contract as the reference helpers).
    """
    import matplotlib
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    fps = int(round(1.0 / dt * speed))

    if save_path is not None and str(save_path).lower().endswith(".gif"):
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        # Render under Agg WITHOUT flipping the process backend for good:
        # the previous matplotlib.use("Agg") was permanent, which made the
        # show-on-failure fallback below (and any later interactive call
        # in the same process) a silent no-op.
        prev_backend = matplotlib.get_backend()
        switched = prev_backend.lower() != "agg"
        if switched:
            plt.switch_backend("Agg")
        try:
            tf = _TopdownFigure(trajs, dt, title, tail_secs, dpi, ncols)
            try:
                # GIF decoders clamp frame delays below ~20 ms (50 fps);
                # when the requested playback is faster, DROP frames so
                # the wall-clock speed is honored instead of silently
                # playing up to speed/50*fps-times slower
                frame_step = max(1, -(-fps // 50))
                _save_gif_fast(tf, save_path, fps, frame_step=frame_step)
                print(f"[ok] Animation saved -> {save_path}")
                return None
            finally:
                plt.close(tf.fig)
        except Exception as e:  # pragma: no cover
            print(f"[warn] Could not save animation ({e}). Showing instead.")
        finally:
            if switched:
                plt.switch_backend(prev_backend)
        save_path = None  # fall through to the interactive path

    tf = _TopdownFigure(trajs, dt, title, tail_secs, dpi, ncols)
    ani = None
    interval_ms = int(max(1, 1000.0 * dt / max(speed, 1e-6)))
    ani = FuncAnimation(tf.fig, lambda i: tuple(tf.update(i)),
                        frames=tf.T, blit=True, interval=interval_ms)
    if save_path is None:
        plt.show()
    else:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        try:
            from matplotlib.animation import FFMpegWriter

            ani.save(save_path, writer=FFMpegWriter(fps=fps), dpi=dpi)
            print(f"[ok] Animation saved -> {save_path}")
        except Exception as e:  # pragma: no cover
            print(f"[warn] Could not save animation ({e}). Showing instead.")
            plt.show()
    plt.close(tf.fig)
    return ani

"""Static publication figures (host-side matplotlib).

Generic version of the reference's LaTeX 2D figure
(``plot_2d_trajectories_with_depth``,
``train_tank_brov2_full_comparison.py:260-447``): x-y trajectories with
constant per-model line colors, discrete time-synchronized markers
(shared viridis color per time slice across all trajectories, with a tick
colorbar), end-of-trajectory heading arrows, and a depth/time textbox;
and the differentiable Fossen fit's coefficient-scales bar chart.
Counterpart of ``bluerov2_dynamics_tpu/viz/plots.py``; matplotlib is
imported inside the functions.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np

from bluerov2_dynamics_tpu_torch.viz.animate import _yaw_of

_STYLES = ["-", "--", "-.", ":", (0, (3, 1, 1, 1))]  # 5 distinct styles


def plot_topdown_with_depth(
    trajs: Dict[str, np.ndarray],
    dt: float,
    seconds: float,
    save_path: str = "media/topdown_2d.png",
    marker_step_seconds: float = 1.0,
    marker_cmap: str = "viridis",
    dpi: int = 300,
    title: str = None,
    obstacles=None,
):
    """Plot the first ~``seconds`` of each trajectory in the x-y plane.

    ``obstacles``: optional iterable of ``(cx, cy, radius)`` keep-out
    disks, drawn shaded under the trajectories (used by the MPPI
    control demo)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import BoundaryNorm
    from matplotlib.lines import Line2D

    names = list(trajs)
    arrays = [np.asarray(trajs[n]) for n in names]
    horizon = min(
        int(seconds / max(dt, 1e-9)), *[a.shape[0] for a in arrays]
    )
    if horizon < 2:
        print("[warn] Not enough steps for 2D plot.")
        return None
    arrays = [a[:horizon] for a in arrays]

    fig, ax = plt.subplots(figsize=(7, 5), dpi=dpi)
    lines = []
    for i, (name, a) in enumerate(zip(names, arrays)):
        (ln,) = ax.plot(
            a[:, 0], a[:, 1], label=name,
            linestyle=_STYLES[i % len(_STYLES)], linewidth=2.5,
        )
        lines.append(ln)
    colors = [ln.get_color() for ln in lines]

    if obstacles:
        from matplotlib.patches import Circle

        for cx, cy, r in obstacles:
            ax.add_patch(Circle((cx, cy), r, facecolor="0.88",
                                edgecolor="k", hatch="///", lw=1.0,
                                zorder=0))

    # time-synchronized discrete markers + colorbar
    if marker_step_seconds > 0:
        step = max(1, int(round(marker_step_seconds / max(dt, 1e-9))))
        idx = np.arange(0, horizon, step)
        n_m = len(idx)
        cmap = plt.get_cmap(marker_cmap, n_m)
        mcolors = cmap(np.arange(n_m))
        for a in arrays:
            ax.scatter(a[idx, 0], a[idx, 1], c=mcolors, s=18,
                       edgecolors="none", zorder=4)
        norm = BoundaryNorm(np.arange(-0.5, n_m + 0.5), ncolors=n_m)
        sm = ScalarMappable(norm=norm, cmap=cmap)
        sm.set_array([])
        cbar = fig.colorbar(sm, ax=ax, pad=0.02)
        cbar.set_label("time [s]", fontsize=9)
        cbar.set_ticks(np.arange(n_m))
        cbar.set_ticklabels([f"{t * dt:.0f}" for t in idx])
        cbar.ax.tick_params(labelsize=8)

    # heading arrows at trajectory ends
    xs = np.concatenate([a[:, 0] for a in arrays])
    ys = np.concatenate([a[:, 1] for a in arrays])
    head = 0.07 * max(1e-6, max(xs.max() - xs.min(), ys.max() - ys.min()))
    for a, color in zip(arrays, colors):
        yaw = float(_yaw_of(a)[-1])
        ax.annotate(
            "",
            xy=(a[-1, 0] + head * math.cos(yaw), a[-1, 1] + head * math.sin(yaw)),
            xytext=(a[-1, 0], a[-1, 1]),
            arrowprops=dict(arrowstyle="->", lw=2.0, color=color),
        )

    # depth/time textbox
    text = [f"t ≈ {(horizon - 1) * dt:5.2f} s"] + [
        f"z_{n} = {a[-1, 2]:.2f} m" for n, a in zip(names, arrays)
    ]
    ax.text(
        0.98, 0.02, "\n".join(text), transform=ax.transAxes,
        va="bottom", ha="right", fontsize=9,
        bbox=dict(boxstyle="round", alpha=0.25),
    )

    ax.set_xlabel("x [m]", fontsize=11)
    ax.set_ylabel("y [m]", fontsize=11)
    ax.set_title(
        title if title is not None
        else f"Open-loop rollout (~{seconds:.1f}s, top view)",
        fontsize=12,
    )
    ax.set_aspect("equal", adjustable="box")
    ax.grid(True, alpha=0.3)
    ax.legend(
        handles=[
            Line2D([0], [0], color=c, linestyle=_STYLES[i % len(_STYLES)],
                   linewidth=2.5, label=n)
            for i, (n, c) in enumerate(zip(names, colors))
        ],
        loc="upper left", fontsize=10,
    )
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    print(f"[ok] 2D trajectory figure saved -> {save_path}")
    return save_path


def plot_coefficient_scales(
    fitted_scales,
    names,
    true_scales=None,
    stderr=None,
    save_path: str = "media/fossen_fit_scales.png",
    dpi: int = 200,
):
    """Bar chart of fitted coefficient scale factors vs the nominal 1.0
    (and, when known — generated datasets — the generator's true draws).

    Companion figure for ``models/sysid.py``: shows WHICH Table A1
    coefficients the differentiable fit moved and by how much.  No
    reference counterpart (the reference's coefficients are hard-coded).
    ``stderr`` (optional, log-space Laplace stderr per coefficient) draws
    ±2σ error bars; non-finite entries (unidentifiable coefficients) are
    skipped.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fitted = np.asarray(fitted_scales, np.float64)
    k = len(fitted)
    x = np.arange(k)
    fig, ax = plt.subplots(figsize=(10, 4), dpi=dpi)
    ax.bar(x, fitted - 1.0, bottom=1.0, width=0.62, label="fitted",
           color="#3b7dd8", zorder=3)
    if stderr is not None:
        se = np.asarray(stderr, np.float64)
        m = np.isfinite(se)
        # log-space stderr -> multiplicative band around the fitted scale
        lo = fitted[m] * (1.0 - np.exp(-2.0 * se[m]))
        hi = fitted[m] * (np.exp(2.0 * se[m]) - 1.0)
        ax.errorbar(x[m], fitted[m], yerr=[lo, hi], fmt="none",
                    ecolor="0.15", elinewidth=1.2, capsize=2.5, zorder=5,
                    label="±2σ (Laplace)")
    if true_scales is not None:
        t = np.asarray(true_scales, np.float64)
        ax.scatter(x, t, marker="_", s=320, linewidths=2.2, color="#d04a35",
                   label="generator truth", zorder=4)
    ax.axhline(1.0, color="0.3", linewidth=1.0, zorder=2)
    ax.set_xticks(x)
    ax.set_xticklabels(list(names)[:k], rotation=60, fontsize=8)
    ax.set_ylabel("scale factor (nominal = 1)", fontsize=10)
    ax.set_title("Differentiable Fossen fit: coefficient scale factors",
                 fontsize=11)
    ax.grid(True, axis="y", alpha=0.3, zorder=0)
    ax.legend(fontsize=9)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    print(f"[ok] Coefficient-scales figure saved -> {save_path}")
    return save_path

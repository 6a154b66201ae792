"""Figures and animations of the port (host matplotlib and PIL, imported
only when a figure is drawn)."""

from bluerov2_dynamics_tpu_torch.viz.animate import animate_topdown  # noqa: F401
from bluerov2_dynamics_tpu_torch.viz.plots import (  # noqa: F401
    plot_coefficient_scales,
    plot_topdown_with_depth,
)

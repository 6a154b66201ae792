"""RK4 workload (T5): the four-model comparison with the physics and DI
models integrated by classic RK4.

Counterpart of ``bluerov2_dynamics_tpu/apps/tank_rk4.py``: the flagship
comparison (:mod:`.tank_full_comparison`) with ``--integrator rk4`` and
``--media-prefix rk4_`` unless the caller names a prefix.  The Fossen row
runs K2 fused in its RK4 form on the card.

Run on the card: ``python -m bluerov2_dynamics_tpu_torch.apps.tank_rk4
--synthetic --recording --steps 45823 --no-media``.
"""

from __future__ import annotations

import sys

from bluerov2_dynamics_tpu_torch.apps import tank_full_comparison


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = ["--integrator", "rk4"]
    if not any(a == "--media-prefix" or a.startswith("--media-prefix=") for a in argv):
        extra += ["--media-prefix", "rk4_"]
    return tank_full_comparison.main(argv + extra, device=device)


if __name__ == "__main__":
    main()

"""What a run may not load: JAX, or the JAX package the port was made from.

Modules are compared by their top-level name (the part before the first
dot), whole: ``bluerov2_dynamics_tpu_torch`` is the port and is allowed,
``bluerov2_dynamics_tpu`` is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bluerov2_dynamics_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)

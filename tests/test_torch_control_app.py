"""The port's control demo (``apps/control_demo.py``) against the JAX
package's, task by task at reduced sizes, on the CPU.

``run_hover``, ``run_waypoint``, ``run_los`` and ``run_ilqr`` run in both
apps (float32, as the apps run) and their returned dicts are compared key
by key: every key of the JAX app's dict is in the port's.  Tolerances: the
tasks without a trim (trajopt, iLQR and its executions) at atol 1e-5
(measured 1.1e-6); hover and the LOS mission at atol 2e-3 on states and
1e-2 on commands (measured 4.4e-4 and 2.3e-3), since both fly
``fossen_lqr``'s gains, whose float32 trim (400 Adam steps) wanders at
float32's floor and lands 7e-4 from the JAX package's; waypoint indices,
hit steps and flags exactly.  Also ``--media-dir``, which renders the
hover task's figure before the work ends (it was refused before the port
had its figures).
"""

import numpy as np
import pytest

from bluerov2_dynamics_tpu.apps import control_demo as jdemo
from bluerov2_dynamics_tpu_torch.apps import control_demo as demo

TIGHT = dict(rtol=0, atol=1e-5)
TRIMMED = {"X": dict(rtol=0, atol=2e-3), "U": dict(rtol=0, atol=1e-2)}
EXACT = ("wp_index", "hit_step", "all_hit")
TASKS = {
    "run_hover": (dict(steps=100), TRIMMED),
    "run_waypoint": (dict(horizon=30, opt_steps=10), None),
    "run_los": (dict(steps=300), TRIMMED),
    "run_ilqr": (dict(horizon=30, iters=2), None),
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_returns_the_jax_apps_dict(task):
    kw, trimmed = TASKS[task]
    want = getattr(jdemo, task)(**kw)
    got = getattr(demo, task)(device="cpu", **kw)
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        g, w = np.asarray(got[k]), np.asarray(v)
        assert g.shape == w.shape, k
        if k in EXACT:
            assert np.array_equal(g, w), k
            continue
        tol = TIGHT if trimmed is None else trimmed.get(k, TRIMMED["X"])
        np.testing.assert_allclose(g.astype(float), w.astype(float), err_msg=k, **tol)


def test_media_dir_is_refused_before_any_work(tmp_path):
    """``--media-dir`` is no longer refused: it writes the task's figure
    under the JAX app's name."""
    demo.main(["hover", "--steps", "50", "--media-dir", str(tmp_path)], device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["control_demo_hover_2D.png"]

"""The port's LOS guidance (``models/guidance.py``) against the JAX
package's on the same inputs, on the CPU.

The geometry, the plan, the waypoint switching (the depth-only waypoint
that the x/y hit test passes at once is pinned, as the JAX package
behaves), the ILOS integrator and its reset on a switch and in hold, whole
missions on a kinematic plant and on the full thruster-lag plant, and the
summary.  Tolerances: float64 at rtol 1e-9, atol 1e-12 (measured 4e-16 on
the full-plant mission); float32 at atol 1e-5 (measured 5e-7); waypoint
indices and hit flags exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluerov2_dynamics_tpu.models import control as jc
from bluerov2_dynamics_tpu.models import fossen as jf
from bluerov2_dynamics_tpu.models import guidance as jg
from bluerov2_dynamics_tpu.models.params import fossen_params as jparams
from bluerov2_dynamics_tpu.models.params import lag_params as jlag
from bluerov2_dynamics_tpu.models.params import thruster_config as jcfg
from bluerov2_dynamics_tpu_torch.models import control, fossen, guidance
from bluerov2_dynamics_tpu_torch.models.params import fossen_params, lag_params, thruster_config

DT = 0.02
F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=0, atol=1e-5)
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# the second waypoint differs from the first in depth only
WPS = [[0.3, 0.0, 0.3], [0.3, 0.0, 0.5], [0.3, 0.3, 0.2], [0.0, 0.3, 0.0]]


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _plans(name, wps=WPS, **kw):
    jd, td = DTYPES[name]
    return (jg.make_plan([0, 0, 0], wps, dtype=jd, **kw),
            guidance.make_plan([0, 0, 0], wps, dtype=td, **kw))


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    a, b, pos = rng.normal(size=(3, 5, 3))
    t = [torch.as_tensor(v) for v in (a, b, pos)]
    close(guidance.path_tangential_angle(t[0], t[1]), jg.path_tangential_angle(a, b), **F64)
    for got, want in zip(guidance.track_errors(*t), jg.track_errors(a, b, pos)):
        close(got, want, **F64)
    close(guidance.los_heading(*t, 0.6), jg.los_heading(a, b, pos, 0.6), **F64)
    # hand geometry: 2 m along and 0.5 m to the left of a path along +x; the
    # correction angle is atan2(-e, Delta)
    s, e = guidance.track_errors(torch.zeros(3), torch.tensor([10.0, 0, 0]),
                                 torch.tensor([2.0, 0.5, 0.0]))
    assert np.isclose(float(s), 2.0) and np.isclose(float(e), 0.5)
    psi = guidance.los_heading(torch.zeros(3), torch.tensor([10.0, 0, 0]),
                               torch.tensor([2.0, 1.0, 0.0]), 0.5)
    assert np.isclose(float(psi), np.arctan2(-1.0, 0.5), atol=1e-6)


def test_make_plan_matches_jax():
    jp, tp = _plans("f64", accept_radius=0.1, lookahead=0.4, cruise_speed=0.3,
                    integral_gain=0.5)
    assert tp.waypoints.shape == (5, 3)
    for f in guidance.WaypointPlan._fields:
        close(getattr(tp, f), getattr(jp, f), rtol=0, atol=0)


def test_advance_index_skips_a_depth_only_waypoint_as_jax_does():
    """At the first waypoint the index advances to the depth-only one,
    whose horizontal distance is already inside the circle, and on the
    next call past it, 0.5 m above it; away from a segment's end it stays;
    at the end it saturates at hold (n + 1)."""
    jp, tp = _plans("f64", accept_radius=0.1)
    cases = [([0.0, 0.0, 0.0], 1), ([0.29, 0.01, 0.0], 1), ([0.29, 0.01, 0.0], 2),
             ([0.1, 0.05, 0.0], 3), ([0.0, 0.31, 0.0], 4), ([0.0, 0.31, 0.0], 5)]
    got = []
    for pos, idx in cases:
        want = int(jg._advance_index(jp, jnp.asarray(pos), jnp.asarray(idx, jnp.int32)))
        ti = guidance._advance_index(tp, torch.as_tensor(pos, dtype=torch.float64),
                                     torch.tensor(idx, dtype=torch.int32))
        assert ti.dtype == torch.int32
        got.append(int(ti))
        assert got[-1] == want, (pos, idx)
    assert got == [1, 2, 3, 3, 5, 5]


def _kinematic(name, kappa, drift):
    """A single-integrator vehicle with a cross drift (so the ILOS
    integrator builds up): surge along psi at u[0], psi and z servos."""
    jd, td = DTYPES[name]
    K = np.zeros((8, 12))
    K[0, 6] = K[1, 5] = K[2, 2] = 1.0
    jpol = jc.LQRPolicy(K=jnp.asarray(K, jd), z_ref=jnp.zeros(12, jd), u_eq=jnp.zeros(8, jd),
                        u_lo=-2.0, u_hi=2.0)
    tpol = control.LQRPolicy(K=torch.as_tensor(K, dtype=td), z_ref=torch.zeros(12, dtype=td),
                             u_eq=torch.zeros(8, dtype=td), u_lo=-2.0, u_hi=2.0)

    def jplant(x, u):
        psi = x[5] + 2.0 * u[1] * DT
        return (x.at[0].add(u[0] * jnp.cos(psi) * DT).at[1].add((u[0] * jnp.sin(psi) + drift) * DT)
                .at[2].add(2.0 * u[2] * DT).at[5].set(psi))

    def tplant(x, u):
        psi = x[5] + 2.0 * u[1] * DT
        return torch.cat([(x[0] + u[0] * torch.cos(psi) * DT)[None],
                          (x[1] + (u[0] * torch.sin(psi) + drift) * DT)[None],
                          (x[2] + 2.0 * u[2] * DT)[None], x[3:5], psi[None], x[6:]])

    jpl, tpl = _plans(name, [[2.0, 0.0, 0.2], [2.0, 2.0, 0.4], [0.0, 2.0, 0.1]],
                      accept_radius=0.1, lookahead=0.4, cruise_speed=0.5, integral_gain=kappa)
    jr = jg.simulate_los_mission(jplant, jpol, jpl, jnp.zeros(12, jd), 700)
    tr = guidance.simulate_los_mission(tplant, tpol, tpl, torch.zeros(12, dtype=td), 700)
    return jr, tr, jpl, tpl


@pytest.mark.parametrize("kappa", [0.0, 0.8])
def test_kinematic_mission_and_the_ilos_integrator_match_jax(kappa):
    """With kappa > 0 the commanded heading carries the integrator, which
    resets at each switch and in hold: equal commanded headings through
    every switch pin the reset."""
    jr, tr, jpl, tpl = _kinematic("f64", kappa, drift=0.1)
    assert np.array_equal(tr.wp_index.numpy(), np.asarray(jr.wp_index))
    assert tr.wp_index.numpy().max() == 4                     # reached hold
    for f in ("X", "U", "cross_track", "psi_d"):
        close(getattr(tr, f), getattr(jr, f), err_msg=f, **F64)


@pytest.fixture(scope="module")
def hover_gains():
    """The JAX package's float64 hover LQR (both dtypes fly its gains)."""
    return jc.fossen_lqr(jparams(), jcfg(), DT, dtype=jnp.float64)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_full_plant_mission_and_summary_match_jax(name, hover_gains):
    """200 steps of the lag plant under the JAX package's hover gains,
    through the depth-only switch, with ILOS on."""
    jd, td = DTYPES[name]
    jp, jcf = jparams(dtype=jd), jcfg(dtype=jd)
    jpol = hover_gains._replace(**{f: getattr(hover_gains, f).astype(jd)
                                  for f in ("K", "z_ref", "u_eq")})
    tpol = control.LQRPolicy(*(torch.as_tensor(np.array(v)) for v in jpol[:3]), -1.0, 1.0)
    jstep = jf.make_thruster_step(jp, jcf, jlag(DT, dtype=jd), DT, "euler")
    tstep = fossen.make_thruster_step(fossen_params(dtype=td, device="cpu"),
                                      thruster_config(dtype=td, device="cpu"),
                                      lag_params(DT, dtype=td, device="cpu"), DT, "euler")
    jpl, tpl = _plans(name, accept_radius=0.1, lookahead=0.3, integral_gain=0.5)
    jr = jg.simulate_los_mission(jstep, jpol, jpl, (jnp.zeros(12, jd), jnp.zeros((8, 3), jd)),
                                 200, get_state=lambda c: c[0])
    tr = guidance.simulate_los_mission(tstep, tpol, tpl, (torch.zeros(12, dtype=td),
                                                           torch.zeros((8, 3), dtype=td)),
                                       200, get_state=lambda c: c[0])
    tol = F64 if name == "f64" else F32
    assert tr.wp_index.dtype == torch.int32
    assert np.array_equal(tr.wp_index.numpy(), np.asarray(jr.wp_index))
    assert tr.wp_index.numpy().max() >= 3                     # through the depth-only switch
    for f in ("X", "U", "cross_track", "psi_d"):
        close(getattr(tr, f), getattr(jr, f), err_msg=f, **tol)
    ts, js = guidance.mission_summary(tr, tpl), jg.mission_summary(jr, jpl)
    assert set(ts) == set(js)
    assert ts["all_hit"] == js["all_hit"]
    assert np.array_equal(ts["hit_step"], js["hit_step"])
    for k in ("min_dist", "final_pos_err", "cross_track_rms"):
        close(ts[k], js[k], err_msg=k, **tol)

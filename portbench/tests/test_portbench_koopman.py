"""The Koopman cells (kinds ``koopman_fit`` and ``koopman_score``) at a cut of
their own on the CPU, through the port's ``koopman.fit`` and
``koopman.multistep_rmse``: correct traced and untraced, their control (the
reference in TF32) not correct, planted faults not correct; their readers on
traces built by hand; the reference imports nothing of the port and no JAX;
and, on the card, each cell and its control at full size."""

import copy
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, guard, harness, kinds, spec
from portbench import koopman_ops as kops
from portbench.kinds import koopman_common
from portbench.reference import koopman as rk
from portbench.reference.fossen import round_tf32
from portbench.tests.test_portbench_guard import _imports
from portbench.trace import Trace

CELLS = ("koopman-fit", "koopman-score")
SEED = 2**31 + 99
FIT_METRICS = ("koopman_seed_ms", "koopman_lloyd_ms", "koopman_normal_eqns_ms",
               "koopman_fit_launches", "device_idle.koopman_fit", "koopman_gram_roofline")


# The fit on 6,000 recorded rows (4,800 to fit) and 100 RBFs, where TF32 in the
# Lloyd distances and a uniform seeding show; the scoring on
# the cell's whole recording (a model fitted to 36,658 rows, scored on 9,165)
# with 8 RBFs, whose yaw winds to tens of radians, where TF32's rounding of
# the lift and the propagation shows as it does in the cell.
CUTS = {"koopman-fit": dict(rows=6000, n_rbfs=100), "koopman-score": dict(rows=None, n_rbfs=8)}


def tiny_cell(name: str) -> spec.Cell:
    """The cell at its cut; two traced requests; H = 1, 10, 100 as in the
    cells."""
    c = spec.cell(spec.load_benchmark(), name)
    c.traffic, c.config = copy.deepcopy(c.traffic), copy.deepcopy(c.config)
    cut = CUTS[name]
    if cut["rows"]:
        c.traffic["recording"].update(rows=cut["rows"])
    c.traffic["trace_requests"] = 2
    k = cut["n_rbfs"]
    c.config["koopman"].update(n_rbfs=k, lift_dim=12 + k, gram_width=20 + k)
    return c


def _run(c, trace=False):
    return harness.run_cell(c, SEED, 0.3, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct(name, trace):
    c = tiny_cell(name)
    r = _run(c, bool(trace))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["checks"]) == set(c.limits["checks"])
    if trace:
        # off the card no device metric and no span metric reads anything
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    c = tiny_cell(name)
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    r = control.readings(c, SEED + 1, 0.1, torch.device("cpu"))
    assert all(r["program"][k] <= limits[k] for k in limits), (r, limits)
    assert any(r["control"][k] > limits[k] for k in limits), (r, limits)


def _plant(mp, fault):
    from bluerov2_dynamics_tpu_torch.eval.metrics import rmse
    from bluerov2_dynamics_tpu_torch.models import koopman
    from bluerov2_dynamics_tpu_torch.ops import kmeans

    if fault == "tf32_lloyd_distances":
        orig = kmeans._pairwise_sqdist

        def tf32_sqdist(X, C):
            if X.dtype != torch.float32:
                return orig(X, C)
            r = round_tf32
            x2 = torch.sum(X * X, dim=1)[:, None]
            c2 = torch.sum(C * C, dim=1)[None, :]
            return torch.clamp(x2 + c2 - 2.0 * r(r(X) @ r(C.T)), min=0.0)
        mp.setattr(kmeans, "_pairwise_sqdist", tf32_sqdist)
    elif fault == "uniform_seeding":
        def uniform(X, k, generator=None):
            rows = torch.randperm(X.shape[0], generator=generator, device=X.device)[:k]
            return X.index_select(0, rows)
        mp.setattr(kmeans, "_kmeanspp_init", uniform)
    elif fault == "ridge_off_by_a_fifth":
        orig = koopman._ridge_solve
        mp.setattr(koopman, "_ridge_solve", lambda G, Y, ridge: orig(G, Y, 1.2 * ridge))
    elif fault == "24_lloyd_rounds":
        orig = koopman.kmeans
        mp.setattr(koopman, "kmeans", lambda X, k, iters, *a: orig(X, k, iters - 1, *a))
    else:
        def tf32_scan(model, X, U, H=10, post_decode=None, method="scan"):
            n_start, r = X.shape[0] - H, round_tf32
            Z = koopman.lift(model, X[:n_start])
            for t in range(H):
                Z = r(r(Z) @ r(model.A.T)) + r(r(U[t:t + n_start]) @ r(model.B.T))
            return rmse(X[H:], Z[:, :model.state_dim])
        mp.setattr(koopman, "multistep_rmse", tf32_scan)


@pytest.mark.parametrize("name,fault", [("koopman-fit", "ridge_off_by_a_fifth"),
                                        ("koopman-fit", "24_lloyd_rounds"),
                                        ("koopman-fit", "tf32_lloyd_distances"),
                                        ("koopman-fit", "uniform_seeding"),
                                        ("koopman-score", "tf32_propagation")])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    r = _run(tiny_cell(name))
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


def test_the_score_cells_weights_are_the_references_fit():
    """Set-up fits the scored model with the reference in float64 from the
    program's seed rows; the program's fit is not called."""
    from bluerov2_dynamics_tpu_torch.models import koopman

    c = tiny_cell("koopman-score")
    calls = []
    orig = koopman.fit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(koopman, "fit", lambda *a, **k: calls.append(1) or orig(*a, **k))
        task = kinds.load("koopman_score")(c.config, c.traffic, SEED, torch.device("cpu"))
        task.setup()
    fit_X, fit_U = koopman_common.splits(c.config, c.traffic, SEED, torch.device("cpu"))["train"]
    want = rk.fit(c.config, fit_X, fit_U, koopman_common.seed_rows(c.config, fit_X, SEED))
    assert not calls
    for got, ref in zip(task.model, want):
        assert got.dtype == torch.float32 and torch.equal(got, ref.float())


def test_reference_kmeanspp_draws_by_squared_distance():
    """1,000 rows near 0 and 10 rows at 100: the D^2 draw of two rows takes
    one of each every time, where a uniform draw would take two near 0."""
    gen = torch.Generator().manual_seed(SEED)
    X = torch.cat([1e-3 * torch.randn(1000, 3, generator=gen, dtype=torch.float64),
                   100.0 + torch.zeros(10, 3, dtype=torch.float64)])
    for s in range(20):
        C = rk.kmeanspp(X, 2, torch.Generator().manual_seed(s))
        assert sorted(bool(c[0] > 50) for c in C) == [False, True]
        assert all(any(torch.equal(c, x) for x in X) for c in C)


def test_reference_objective_is_the_nearest_centers_squared_distance():
    gen = torch.Generator().manual_seed(SEED)
    X = torch.randn(5000, 4, generator=gen, dtype=torch.float64)
    C = torch.randn(7, 4, generator=gen, dtype=torch.float64)
    want = float(((X[:, None] - C[None]) ** 2).sum(-1).min(1).values.sum())
    assert rk.objective(X, C) == pytest.approx(want, rel=1e-12)


def test_gram_counts_the_symmetric_half():
    """``G^T G`` at ``p m^2`` (its needed half) and ``G^T Z+`` at ``2 p m d``,
    at the cell's shape: 36,657 pairs, d = 512, m = 520."""
    p, d, m = 36657, 512, 520
    assert kops.gram_ops(p, d, m - d) == p * m * m + 2 * p * m * d == 29_431_172_160


def test_reference_imports_nothing_of_the_port_or_jax():
    for mod in _imports(spec.HERE / "reference" / "koopman.py"):
        assert mod.split(".", 1)[0] not in {"bluerov2_dynamics_tpu_torch"} | guard.FORBIDDEN, mod
    code = ("import sys; sys.path[0] = {r!r}; import portbench.reference.koopman; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('bluerov2') "
            "or m.split('.')[0] in {f!r}))").format(r=str(spec.ROOT), f=set(guard.FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stdout + p.stderr


# ---------------------------------------------------------------------------
# The readers, on traces built by hand
# ---------------------------------------------------------------------------

GEMM = "sm90_xmma_gemm_f64f64"


def _fit_ctx(on_card=True, fits=2, spans_a_fit=1, gram_kernels=True):
    """``fits`` fits 10 ms apart: seed 4 ms, lloyd 2 ms, normal_eqns 1 ms
    long; each fit launches 3 kernels of 0.5 ms and a copy, and its two
    Gram GEMMs (0.6 and 0.4 ms) under ``aten::mm``."""
    host, device, launched = [], [], []
    for f in range(fits):
        t = 10_000_000 * f
        for _ in range(spans_a_fit):
            host += [("brov2.koopman.seed", t, t + 4_000_000),
                     ("brov2.koopman.lloyd", t + 4_000_000, t + 6_000_000),
                     ("brov2.koopman.normal_eqns", t + 6_000_000, t + 7_000_000)]
        device += [("k", t + 500_000 * i, t + 500_000 * (i + 1)) for i in range(3)]
        device.append(("Memcpy DtoD", t + 2_000_000, t + 2_100_000))
        grams = [(GEMM, "aten::mm", t + 7_000_000, t + 7_600_000),
                 (GEMM, "aten::mm", t + 7_600_000, t + 8_000_000)] if gram_kernels else []
        launched.append(grams + [("Memset (Device)", "aten::mm", t + 7_000_000, t + 7_000_100),
                                 ("potrf", "aten::linalg_cholesky_ex", t + 8_000_000,
                                  t + 8_200_000)])
    trace = {"window": Trace(device, host, (0, 10_000_000 * fits)), "requests": fits,
             "launched": {"brov2.koopman.normal_eqns": launched}}
    return SimpleNamespace(on_card=on_card, trace=trace,
                           shapes={"gram_ops": 67e9, "gram_bytes": 0.0})


def _score_ctx(on_card=True, requests=2, horizons=(1, 10), per=None):
    """Each horizon's propagate span 100 + 10 k us long, launching 2 kernels
    of 0.25 ms; the horizons' bound 0.1 ms each."""
    host, launched, k = [], [], 0
    for _ in range(requests):
        for _ in horizons:
            t = 1_000_000 * k
            host.append(("brov2.koopman.propagate", t, t + 100_000 + 10_000 * k))
            launched.append([("gemm", "aten::mm", t, t + 250_000),
                             ("add", "aten::add", t + 250_000, t + 500_000)])
            k += 1
    per = per or {H: {"prop_ops": 6.7e9, "prop_bytes": 0.0} for H in horizons}
    trace = {"window": Trace([], host, (0, 1_000_000 * k)), "requests": requests,
             "launched": {"brov2.koopman.propagate": launched}}
    return SimpleNamespace(on_card=on_card, trace=trace,
                           shapes={"horizons": list(horizons), "per_horizon": per})


def test_fit_readers():
    ctx = _fit_ctx()
    assert harness.read_metric("koopman_seed_ms", ctx) == pytest.approx(4.0)
    assert harness.read_metric("koopman_lloyd_ms", ctx) == pytest.approx(2.0)
    assert harness.read_metric("koopman_normal_eqns_ms", ctx) == pytest.approx(1.0)
    assert harness.read_metric("koopman_fit_launches", ctx) == 3.0
    # 3 x 0.5 ms and a 0.1 ms copy busy of each 10 ms fit
    assert harness.read_metric("device_idle.koopman_fit", ctx) == pytest.approx(84.0)
    # the Gram's 67 GFLOP bound 1 ms a fit, its two GEMMs 1 ms a fit
    assert harness.read_metric("koopman_gram_roofline", ctx) == pytest.approx(100.0)


def test_score_readers():
    ctx = _score_ctx()
    # spans of 100, 110, 120, 130 us
    assert harness.read_metric("koopman_propagate_ms", ctx) == pytest.approx(0.115)
    # 2 horizons' 0.1 ms bound over 2 x 0.5 ms of kernels, a scoring
    assert harness.read_metric("koopman_prop_roofline", ctx) == pytest.approx(20.0)


@pytest.mark.parametrize("name", FIT_METRICS)
def test_fit_readers_read_nothing_off_the_card(name):
    assert harness.read_metric(name, _fit_ctx(on_card=False)) is None


@pytest.mark.parametrize("name", ["koopman_propagate_ms", "koopman_prop_roofline"])
def test_score_readers_read_nothing_off_the_card(name):
    assert harness.read_metric(name, _score_ctx(on_card=False)) is None


@pytest.mark.parametrize("name", ["koopman_seed_ms", "koopman_lloyd_ms",
                                  "koopman_normal_eqns_ms", "koopman_gram_roofline"])
@pytest.mark.parametrize("spans_a_fit", [0, 2])
def test_fit_span_readers_refuse_a_wrong_count(name, spans_a_fit):
    ctx = _fit_ctx(spans_a_fit=spans_a_fit)
    if name == "koopman_gram_roofline":
        occ = ctx.trace["launched"]["brov2.koopman.normal_eqns"]
        ctx.trace["launched"]["brov2.koopman.normal_eqns"] = occ[:1] if spans_a_fit == 0 else occ * 2
    assert harness.read_metric(name, ctx) is None


def test_gram_roofline_reads_nothing_without_its_gemms():
    assert harness.read_metric("koopman_gram_roofline", _fit_ctx(gram_kernels=False)) is None


@pytest.mark.parametrize("horizons", [(1,), (1, 10, 100)])
@pytest.mark.parametrize("name", ["koopman_propagate_ms", "koopman_prop_roofline"])
def test_score_span_readers_refuse_a_wrong_count(name, horizons):
    ctx = _score_ctx(horizons=horizons)
    ctx.shapes["horizons"] = [1, 10]
    ctx.shapes["per_horizon"] = {1: ctx.shapes["per_horizon"][horizons[0]],
                                 10: ctx.shapes["per_horizon"][horizons[0]]}
    assert harness.read_metric(name, ctx) is None


class _Event:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, on_device, start, dur, corr=0, linked=0, tid=1, annotation=False):
        from torch.autograd import DeviceType

        self._v = dict(name=name, device_type=DeviceType.CUDA if on_device else DeviceType.CPU,
                       start_ns=start, duration_ns=dur, correlation_id=corr,
                       linked_correlation_id=linked, start_thread_id=tid,
                       is_user_annotation=annotation)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_launched_links_device_events_to_the_ops_inside_each_span():
    ev = [_Event("brov2.koopman.propagate", False, 100, 100, corr=1, annotation=True),
          _Event("aten::mm", False, 110, 10, corr=2),
          _Event("cudaLaunchKernel", False, 112, 2, corr=90, linked=2),
          _Event("aten::add", False, 150, 10, corr=3),
          _Event("aten::mm", False, 250, 10, corr=4),            # after the span
          _Event("aten::mm", False, 120, 10, corr=5, tid=2),     # another thread
          _Event("gemm", True, 300, 50, corr=90, linked=2),
          _Event("add", True, 350, 20, linked=3),
          _Event("later", True, 400, 20, linked=4),
          _Event("other", True, 420, 20, linked=5),
          _Event("brov2.koopman.propagate", True, 100, 100, annotation=True)]
    got = koopman_common.launched(ev, 1, ["brov2.koopman.propagate", "brov2.koopman.seed"])
    assert got == {"brov2.koopman.propagate": [[("gemm", "aten::mm", 300, 350),
                                                ("add", "aten::add", 350, 370)]],
                   "brov2.koopman.seed": []}


# ---------------------------------------------------------------------------
# On the card, at the cells' own size
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_and_its_control_on_the_card(card, name):
    """Each cell at its own size, a short window, correct; its control (the
    reference in TF32 in the program's place) fails at least one check."""
    c = spec.cell(spec.load_benchmark(), name)
    r = harness.run_cell(c, 2**31 + 77, 3.0, False, card, time.perf_counter())
    assert r["correct"] is True, r["checks"]
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    ctl = control.readings(c, 2**31 + 78, 1.0, card)
    print(name, ctl)
    assert all(ctl["program"][k] <= limits[k] for k in limits), (ctl, limits)
    assert any(ctl["control"][k] > limits[k] for k in limits), (ctl, limits)


@pytest.mark.cuda
def test_24_lloyd_rounds_at_the_cells_size_is_not_correct(card, monkeypatch):
    """The round missing at full size, where float32's own flips move the
    centers further than the round does: the float64 fit catches it."""
    _plant(monkeypatch, "24_lloyd_rounds")
    c = spec.cell(spec.load_benchmark(), "koopman-fit")
    r = harness.run_cell(c, SEED, 1.0, False, card, time.perf_counter())
    print(r["checks"])
    assert r["correct"] is False
    assert r["checks"]["float64_fit_gap"]["value"] > r["checks"]["float64_fit_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault,check", [("tf32_lloyd_distances", "objective_gap"),
                                         ("uniform_seeding", "seed_objective_gap")])
def test_fit_faults_of_the_timed_path_at_the_cells_size_are_not_correct(card, monkeypatch,
                                                                        fault, check):
    """TF32 in the Lloyd distances, which the k-means objective of the timed
    float32 fit catches, and a draw without the D^2 weighting, which the
    seed rows' objective catches."""
    _plant(monkeypatch, fault)
    c = spec.cell(spec.load_benchmark(), "koopman-fit")
    r = harness.run_cell(c, SEED, 1.0, False, card, time.perf_counter())
    print(fault, r["checks"])
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]

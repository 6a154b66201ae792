"""The readers of the program's spans (``portbench/spans.py`` and the seven
``metrics/`` files that use it) on traces built by hand: their arithmetic,
nothing off the card, nothing on a wrong count of spans."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.trace import Trace

KERNEL = "window_eval_kernel"
SCORE = ("score_evaluate_us", "score_launch_host_us", "score_rmse_host_us")
SOLVE = ("solve_lag_history_s", "solve_capture_s", "solve_replay_ms", "device_idle.solve_replay")


def _score_ctx(host, on_card=True, requests=2, horizons=(1, 10)):
    device = [(KERNEL, 0, 10)]
    return SimpleNamespace(on_card=on_card, shapes={"horizons": list(horizons)},
                           trace={"window": Trace(device, host, (0, 10_000)),
                                  "requests": requests})


def _score_host(n):
    """``n`` horizons' calls 1,000 ns apart: evaluate 100 + 10 k ns long,
    the launch 40 + k and the epilogue 20 + 2 k inside it."""
    host = []
    for k in range(n):
        t = 1_000 * k
        host += [("brov2.evaluate", t, t + 100 + 10 * k),
                 ("brov2.wrapper.launch", t + 5, t + 45 + k),
                 ("aten::empty", t + 10, t + 12),
                 ("brov2.wrapper.rmse", t + 50, t + 70 + 2 * k),
                 ("aten::div", t + 52, t + 55)]
    return host


def _solve_trace(replays=1, captures=1, lag=1):
    host = [("brov2.sysid.lag_history", 1_000, 3_001_000)] * lag
    host += [("brov2.sysid.capture", 4_000_000, 6_000_000)] * captures
    host += [("brov2.sysid.replay", 7_000_000, 7_120_000)] * replays
    # kernels of the replays: one across the span's start, two inside that
    # overlap, one across its end; one kernel before the span
    device = [("k", 6_900_000, 7_010_000), ("k", 7_020_000, 7_060_000),
              ("k", 7_050_000, 7_080_000), ("k", 7_110_000, 7_200_000),
              ("Memcpy HtoD", 5_000_000, 5_100_000)]
    return Trace(device, host, (0, 8_000_000))


def _solve_ctx(on_card=True, **counts):
    return SimpleNamespace(on_card=on_card, shapes={"trace_steps": (2, 12)},
                           trace={"fit2": Trace([], [], (0, 1)), "fit12": _solve_trace(**counts)})


def test_busy_time_inside_a_span_is_clipped_to_it():
    tr = _solve_trace()
    # 7.00-7.01 ms clipped, 7.02-7.08 ms as one union, 7.11-7.12 ms clipped
    assert spans.busy_s(tr, (7_000_000, 7_120_000)) == pytest.approx(80e-6, abs=1e-15)
    assert spans.busy_s(tr, (0, 1_000_000)) == 0.0
    assert spans.busy_s(tr, (5_050_000, 5_060_000)) == pytest.approx(10e-6, abs=1e-15)
    assert spans.intervals(tr, "brov2.sysid.replay") == [(7_000_000, 7_120_000)]
    assert spans.intervals(tr, "brov2.evaluate") == []


def test_score_readers_average_the_spans_of_every_horizon():
    ctx = _score_ctx(_score_host(4))
    # k = 0..3: evaluate 100 + 10 k, launch 40 + k, epilogue 20 + 2 k ns
    assert harness.read_metric("score_evaluate_us", ctx) == pytest.approx(0.115)
    assert harness.read_metric("score_launch_host_us", ctx) == pytest.approx(0.0415)
    assert harness.read_metric("score_rmse_host_us", ctx) == pytest.approx(0.023)


def test_solve_readers_read_the_longer_fit():
    ctx = _solve_ctx()
    assert harness.read_metric("solve_lag_history_s", ctx) == pytest.approx(3e-3)
    assert harness.read_metric("solve_capture_s", ctx) == pytest.approx(2e-3)
    assert harness.read_metric("solve_replay_ms", ctx) == pytest.approx(0.12 / 12)
    assert harness.read_metric("device_idle.solve_replay", ctx) == pytest.approx(
        100.0 * (1 - 80 / 120))


@pytest.mark.parametrize("name", SCORE + SOLVE)
def test_nothing_off_the_card(name):
    ctx = _score_ctx(_score_host(4), on_card=False) if name in SCORE else _solve_ctx(False)
    assert harness.read_metric(name, ctx) is None


@pytest.mark.parametrize("n", [0, 3, 5])
@pytest.mark.parametrize("name", SCORE)
def test_score_readers_refuse_a_wrong_count(name, n):
    assert harness.read_metric(name, _score_ctx(_score_host(n))) is None


@pytest.mark.parametrize("count", [0, 2])
@pytest.mark.parametrize("name", SOLVE)
def test_solve_readers_refuse_a_wrong_count(name, count):
    key = {"solve_lag_history_s": "lag", "solve_capture_s": "captures"}.get(name, "replays")
    assert harness.read_metric(name, _solve_ctx(**{key: count})) is None

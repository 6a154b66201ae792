"""PINc training's captured minibatch step (``models/pinc.py::_CapturedStep``).

On the CPU: which path ``train_from_draws`` takes, read through
``pinc.STEPS`` (eager on the CPU and under a mesh; ``graph=True`` off CUDA
or with a mesh raises), and ``AdamWClip``'s device-side count, bias
corrections and rate table against the host arithmetic it replaced, bit
for bit over 5 steps.

On the card (marker ``cuda``): the graph path against the eager path over
2 epochs of 6 minibatches with the rollout loss on, in float32 and
float64, with the constant rate and the cosine schedule, and with 1 and 3
warm-up steps before the capture: every minibatch's loss and every
parameter within 1e-6 relative (the largest gap is printed), 12 replayed
and no eager minibatch; and a profiled graph training is one capture span
and one replay span, with no per-minibatch span.  The file imports no
JAX.
"""

import copy

import pytest
import torch

from bluerov2_dynamics_tpu_torch.models import params, pinc
from bluerov2_dynamics_tpu_torch.ops import scan

BATCH, N_BATCHES, EPOCHS = 64, 6, 2
TC = pinc.TrainConfig(epochs=EPOCHS, batch=BATCH, rollout_steps=5, rollout_windows=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graph of a PINc minibatch step")
    return torch.device("cuda")


def _problem(dtype=torch.float32, device="cpu", seed=3):
    """Seeded random pairs for 6 minibatches of 64, a net, and 2 epochs'
    draws of 6 minibatches each."""
    g = torch.Generator().manual_seed(seed)
    n = N_BATCHES * BATCH + 20
    data = pinc.PINcData(*(torch.randn((n, w), generator=g, dtype=torch.float64).to(dtype)
                           for w in (14, 9, 4)))
    data = pinc.PINcData(*(t.to(device) for t in data))
    net = pinc.init_params(torch.Generator().manual_seed(seed + 1), dtype=dtype).to(device)
    draws = [tuple(t.to(device) for t in pinc.epoch_draws(g, n, N_BATCHES, BATCH, TC))
             for _ in range(EPOCHS)]
    return net, data, draws


def _steps_of(fn):
    """``fn()``'s result and the minibatches it ran, by path."""
    before = dict(pinc.STEPS)
    out = fn()
    return out, {k: pinc.STEPS[k] - before[k] for k in before}


# --- the path ---------------------------------------------------------------------------------

@pytest.mark.parametrize("device,mesh,want", [("cuda", False, True), ("cuda", True, False),
                                              ("cpu", False, False), ("cpu", True, False)])
def test_the_default_path_follows_the_device_and_the_mesh(device, mesh, want):
    assert scan.use_graph(None, torch.device(device), object() if mesh else None) is want
    assert scan.use_graph(False, torch.device(device), object() if mesh else None) is False


def test_cpu_trains_eagerly_and_refuses_a_graph():
    net, data, draws = _problem()
    rp = params.reduced_params(device="cpu")
    (_, hist), steps = _steps_of(lambda: pinc.train_from_draws(net, data, draws, TC, rp=rp))
    assert steps == {"replayed": 0, "eager": EPOCHS * N_BATCHES} and len(hist) == EPOCHS
    with pytest.raises(ValueError, match="CUDA"):
        pinc.train_from_draws(net, data, draws, TC, rp=rp, graph=True)


@pytest.fixture
def mesh1():
    """A one-rank gloo group in this process, torn down after the test."""
    import torch.distributed as dist

    from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh

    pmesh.init_group("gloo")
    try:
        yield pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_a_mesh_trains_eagerly_and_refuses_a_graph(mesh1):
    net, data, draws = _problem()
    rp = params.reduced_params(device="cpu")
    (_, hist), steps = _steps_of(
        lambda: pinc.train_from_draws(copy.deepcopy(net), data, draws, TC, rp=rp, mesh=mesh1))
    assert steps == {"replayed": 0, "eager": EPOCHS * N_BATCHES} and len(hist) == EPOCHS
    with pytest.raises(ValueError, match="mesh"):
        pinc.train_from_draws(net, data, draws, TC, rp=rp, mesh=mesh1, graph=True)


# --- the optimiser ----------------------------------------------------------------------------

def _host_adamw(params_, grads, lr, clip_norm, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """The update as it was written with a host count: the bias corrections
    and the rate (a float or a ``count -> float`` schedule) Python floats."""
    params_ = [p.clone() for p in params_]
    mu = [torch.zeros_like(p) for p in params_]
    nu = [torch.zeros_like(p) for p in params_]
    for count, gs in enumerate(grads):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
        keep = g_norm < clip_norm
        gs = [torch.where(keep, g, (g / g_norm) * clip_norm) for g in gs]
        bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
        step_size = -(lr(count) if callable(lr) else lr)
        for p, g, m, v in zip(params_, gs, mu, nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            p.add_(step_size * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p))
    return params_


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_device_count_and_rates_give_the_host_arithmetics_updates(schedule, dtype):
    g = torch.Generator().manual_seed(11)
    ps = [torch.randn(s, generator=g, dtype=dtype) for s in ((3, 4), (5,), ())]
    # the first two steps clip, the last three do not
    grads = [[torch.randn(p.shape, generator=g, dtype=dtype) * scale for p in ps]
             for scale in (30.0, 30.0, 0.3, 0.3, 0.3)]
    tc = pinc.TrainConfig(lr_schedule=schedule)
    total = 20
    want = _host_adamw(ps, grads, pinc.warmup_cosine_schedule(tc.lr, total)
                       if schedule == "cosine" else tc.lr, tc.clip_norm)
    got = [p.clone() for p in ps]
    opt = pinc.make_optimizer(tc, got, total_steps=total)
    assert opt.count.dtype == torch.float64 and opt.count.shape == ()
    assert opt.rates.numel() == (total + 1 if schedule == "cosine" else 1)
    for gs in grads:
        opt.step(gs)
    assert float(opt.count) == len(grads)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b), (a, b)


# --- on the card ------------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _train(net0, data, draws, tc, graph, rp):
    """The epochs of ``draws`` (their per-epoch mean losses), then the same
    minibatches as one-minibatch epochs (their per-minibatch losses), each
    from a copy of ``net0``; the parameters of the first."""
    net, hist = pinc.train_from_draws(copy.deepcopy(net0), data, draws, tc, rp=rp, graph=graph)
    single = [(p[k:k + 1], s[k:k + 1]) for p, s in draws for k in range(p.shape[0])]
    _, per_step = pinc.train_from_draws(copy.deepcopy(net0), data, single, tc, rp=rp,
                                        graph=graph)
    return torch.tensor(hist), torch.tensor(per_step), list(net.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("warmup", [1, 3])
@pytest.mark.parametrize("schedule", ["const", "cosine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_training_matches_the_eager_training(cuda, dtype, schedule, warmup, monkeypatch):
    monkeypatch.setattr(pinc, "GRAPH_WARMUP", warmup)
    net0, data, draws = _problem(dtype, cuda)
    tc = TC._replace(lr_schedule=schedule)
    rp = params.reduced_params(dtype=dtype, device=cuda)
    eager, steps = _steps_of(lambda: _train(net0, data, draws, tc, False, rp))
    assert steps == {"replayed": 0, "eager": 2 * EPOCHS * N_BATCHES}
    graph, steps = _steps_of(lambda: _train(net0, data, draws, tc, True, rp))
    assert steps == {"replayed": 2 * EPOCHS * N_BATCHES, "eager": 0}
    gaps = {"epoch loss": _rel(graph[0], eager[0]), "minibatch loss": _rel(graph[1], eager[1]),
            "parameter": max(_rel(a, b) for a, b in zip(graph[2], eager[2]))}
    print(f"graph against eager, {dtype}, {schedule}, warm-up {warmup}: largest gaps {gaps}")
    assert eager[1].shape == (EPOCHS * N_BATCHES,) and torch.isfinite(eager[1]).all()
    assert all(v <= 1e-6 for v in gaps.values()), gaps
    # the net was trained in place, away from its start
    assert max(_rel(a, b) for a, b in zip(graph[2], net0.parameters())) > 1e-3


@pytest.mark.cuda
def test_graph_training_is_one_capture_span_and_one_replay_span(cuda):
    from torch.profiler import ProfilerActivity, profile

    net, data, draws = _problem(device=cuda)
    rp = params.reduced_params(device=cuda)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pinc.train_from_draws(net, data, draws, TC, rp=rp)
    names = [e.name for e in prof.events()]
    counts = {n: names.count(n) for n in ("brov2.pinc.capture", "brov2.pinc.replay",
                                          "brov2.pinc.loss", "brov2.pinc.grad",
                                          "brov2.pinc.optim")}
    assert counts == {"brov2.pinc.capture": 1, "brov2.pinc.replay": 1, "brov2.pinc.loss": 0,
                      "brov2.pinc.grad": 0, "brov2.pinc.optim": 0}, counts

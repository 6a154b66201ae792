"""The port's PINc model (``models/pinc.py``) and the reduced RHS against the
JAX package's on the same inputs, made with numpy from a seed; the JAX
package's flax parameters reach the port through ``convert``.

Tolerances (measured values in brackets):
- float64: the state conversions, ``reduced_rhs`` and the lag-filtered
  wrench at rtol 1e-12 [0; the wrench 3.2e-14 abs on values up to 96];
  the forward at atol 1e-12 on outputs up to ~7 [7.2e-15]; the endpoint
  RMSE and the rollout at rtol 1e-10 [3.1e-16, 1.2e-14 abs].
- explicit float32: one forward at atol 1e-5 on outputs up to ~7
  [6.0e-6: float32 matmuls summed in another order]; ``reduced_rhs`` and
  the wrench at rtol 1e-5 [0; 1.5e-5 abs on 73]; the losses at rtol 1e-5
  [0]; the endpoint RMSE over up to 20 steps at rtol 1e-4 [1.1e-7].
- the AdamW, clip and schedule chain against optax, 20 steps of fixed
  gradients: rtol 1e-6 [0, the same bits]; the schedule at rtol 1e-12.
- three epochs of float32 training fed the JAX package's initial
  parameters and draws (12 Adam steps): the loss history at rtol 1e-5
  [8.2e-8], the final parameters at rtol 1e-5, atol 1e-6 [1.2e-7 abs].
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_rank_checks as trc
from bluerov2_dynamics_tpu.models import fossen as jfossen
from bluerov2_dynamics_tpu.models import params as jparams
from bluerov2_dynamics_tpu.models import pinc as jpinc
from bluerov2_dynamics_tpu_torch import convert
from bluerov2_dynamics_tpu_torch.models import fossen as tfossen
from bluerov2_dynamics_tpu_torch.models import params as tparams
from bluerov2_dynamics_tpu_torch.models import pinc as tpinc

DT = 0.02
HIDDEN, TRAIN = trc.PINC_HIDDEN, trc.PINC_TRAIN
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def recording(seed=0, N=260):
    """A thruster recording (X12, U8) simulated by the JAX package, float32."""
    rng = np.random.default_rng(seed)
    U = np.clip(np.cumsum(rng.normal(size=(N, 8)) * 0.1, axis=0), -1, 1).astype(np.float32)
    x0 = jnp.zeros(12, jnp.float32).at[2].set(1.0)
    X = jfossen.simulate_thruster(jparams.fossen_params(dtype=jnp.float32),
                                  jparams.thruster_config(dtype=jnp.float32),
                                  jparams.lag_params(DT, dtype=jnp.float32), x0,
                                  jnp.asarray(U), DT)[:-1]
    return np.asarray(X) + (rng.normal(size=(N, 12)) * 1e-3).astype(np.float32), U


def flat(tree, prefix):
    """A flax parameter tree as ``{"prefix.Dense_0.kernel": array, ...}``."""
    return {f"{prefix}.{a}.{b}": np.array(v) for a, sub in tree.items() for b, v in sub.items()}


def jax_training(seed=0):
    """``pinc.train`` on a small recording, with what it drew: the initial
    parameters and each epoch's permutation and window starts, replayed
    from the key as ``pinc.py:434,473-480`` splits it."""
    X, U = recording(seed)
    jdata = jpinc.make_dataset(jnp.asarray(X), jnp.asarray(U), DT,
                               jparams.thruster_config(dtype=jnp.float32),
                               jparams.lag_params(DT, dtype=jnp.float32))
    tc = jpinc.TrainConfig(**TRAIN)
    key = jax.random.PRNGKey(seed)
    _, params, hist = jpinc.train(key, jdata, tc, HIDDEN)
    key, init_key = jax.random.split(key)
    mu, sigma = jpinc.input_stats(jdata.z)
    _, params0 = jpinc.init_params(init_key, HIDDEN, dtype=jnp.float32, norm_mu=mu,
                                   norm_sigma=sigma, position_invariant=True)
    N = jdata.z.shape[0]
    batch = min(tc.batch, N)
    nb = max(N // batch, 1)
    perms, starts = [], []
    for _ in range(tc.epochs):
        key, pkey, wkey = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(pkey, N)[: nb * batch]).reshape(nb, batch))
        starts.append(np.asarray(jax.random.randint(
            wkey, (nb, tc.rollout_windows), 0, max(N - tc.rollout_steps - 1, 1))))
    return dict(z=np.array(jdata.z), y=np.array(jdata.y), u4=np.array(jdata.u4), mu=mu,
                sigma=sigma, perms=np.stack(perms), starts=np.stack(starts),
                hist=np.asarray(hist), **flat(params0["params"], "params0"),
                **flat(params["params"], "params"))


@pytest.fixture(scope="module")
def trained():
    return jax_training()


def _jnet(rng, dtype=jnp.float32, ln_eps=1e-6, pi=True, hidden=HIDDEN):
    """A JAX PINc at random (not initial) parameters and its port twin."""
    mu, sigma = rng.normal(size=14) * 0.1, 0.5 + rng.random(14)
    jnet, params = jpinc.init_params(jax.random.PRNGKey(3), hidden, norm_mu=mu, norm_sigma=sigma,
                                     position_invariant=pi, ln_eps=ln_eps)
    params = jax.tree.map(lambda a: a + 0.3 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
                          params)
    tnet = convert.pinc_params_from_numpy(jax.tree.map(np.asarray, params), mu, sigma, hidden,
                                          position_invariant=pi, ln_eps=ln_eps, device="cpu")
    return jnet, params, tnet


def _z(rng, n=200):
    z = rng.normal(size=(n, 14))
    psi = rng.uniform(-3, 3, n)
    z[:, 3], z[:, 4], z[:, 13] = np.cos(psi), np.sin(psi), DT
    return z


# --- conversions, reduced RHS, wrench ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_conversions_match_jax(dtype, rng):
    X12 = (rng.normal(size=(50, 12)) * 3).astype(dtype)
    X9 = tpinc.state12_to_9(torch.from_numpy(X12))
    np.testing.assert_allclose(X9.numpy(), np.asarray(jpinc.state12_to_9(jnp.asarray(X12))),
                               rtol=1e-12 if dtype == np.float64 else 1e-6, atol=0)
    X9n = X9.numpy()
    np.testing.assert_allclose(tpinc.state9_to_12(X9).numpy(),
                               np.asarray(jpinc.state9_to_12(jnp.asarray(X9n))),
                               rtol=1e-12 if dtype == np.float64 else 1e-6, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reduced_rhs_matches_jax(dtype, rng):
    x9 = rng.normal(size=(64, 9)).astype(dtype)
    u4 = (rng.normal(size=(64, 4)) * 20).astype(dtype)
    got = tfossen.reduced_rhs(tparams.reduced_params(dtype=TDTYPE[dtype], device="cpu"),
                              torch.from_numpy(x9), torch.from_numpy(u4))
    want = jfossen.reduced_rhs(jparams.reduced_params(dtype=dtype), jnp.asarray(x9),
                               jnp.asarray(u4))
    assert got.dtype == TDTYPE[dtype] and got.shape == (64, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12 if dtype == np.float64 else 1e-5, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wrench4_from_thrusters_matches_jax(dtype, rng):
    U8 = np.clip(rng.normal(size=(80, 8)), -1, 1).astype(dtype)
    got = tpinc.wrench4_from_thrusters(tparams.thruster_config(dtype=TDTYPE[dtype], device="cpu"),
                                       tparams.lag_params(DT, dtype=TDTYPE[dtype], device="cpu"),
                                       torch.from_numpy(U8))
    want = jpinc.wrench4_from_thrusters(jparams.thruster_config(dtype=dtype),
                                        jparams.lag_params(DT, dtype=dtype), jnp.asarray(U8))
    assert got.shape == (80, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12 if dtype == np.float64 else 1e-5,
                               atol=1e-12 if dtype == np.float64 else 1e-5)


# --- the network ------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ln_eps,pi", [(1e-6, True), (1e-5, False)])
def test_forward_from_converted_jax_params(dtype, ln_eps, pi, rng):
    jnet, params, tnet = _jnet(rng, ln_eps=ln_eps, pi=pi)
    z = _z(rng).astype(dtype)
    want = np.asarray(jnet.apply(params, jnp.asarray(z)))
    got = tnet.to(TDTYPE[dtype])(torch.from_numpy(z)).detach()
    assert got.dtype == TDTYPE[dtype] and got.shape == (200, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 if dtype == np.float64 else 1e-5)
    np.testing.assert_allclose(got[:, 3] ** 2 + got[:, 4] ** 2, 1.0, atol=1e-5)


def test_layernorm_matches_flax_at_its_epsilon(rng):
    """flax's ``LayerNorm`` (fast variance, epsilon 1e-6), not torch's
    (two-pass, 1e-5): on rows of small variance the epsilons part."""
    import flax.linen as nn

    x = rng.normal(size=(8, 16)) * 3e-3 + rng.normal(size=(8, 1))
    ln = nn.LayerNorm()
    want = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    got = tpinc.FastVarLayerNorm(16).double()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    torch_ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (16,)).numpy()
    assert np.abs(torch_ln - want).max() > 1e-2


def test_nan_position_stays_nan_and_the_mask_hides_positions(rng):
    _, _, tnet = _jnet(rng)
    tnet = tnet.double()
    z = torch.from_numpy(_z(rng, 4))
    base = tnet(z).detach()
    moved = z.clone()
    moved[:, 2] += 5.0                      # z enters the MLP masked: only the residual moves
    np.testing.assert_allclose((tnet(moved).detach() - base)[:, 2].numpy(), 5.0, atol=1e-12)
    z[0, 0] = float("nan")
    out = tnet(z).detach()
    assert torch.isnan(out[0]).any() and torch.isfinite(out[1:]).all()


def test_init_params_layout_and_statistics():
    g = torch.Generator().manual_seed(0)
    net = tpinc.init_params(g, (64, 64, 64, 64), norm_mu=np.zeros(14), norm_sigma=np.ones(14))
    _, jp = jpinc.init_params(jax.random.PRNGKey(0), (64, 64, 64, 64))
    got = convert.pinc_params_to_numpy(net)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, jax.device_get(jp))
    for i, lin in enumerate(tpinc.linears(net)):
        w = lin.weight.detach().numpy()
        assert np.abs(w).max() <= 2.0 * math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
        np.testing.assert_allclose(w.std(), math.sqrt(1.0 / lin.in_features), rtol=0.15)
        assert not lin.bias.detach().any()
    for k in range(4):
        assert float(net.net[3 * k + 1].beta.detach()) == 1.0
        assert net.net[3 * k + 2].weight.eq(1).all() and not net.net[3 * k + 2].bias.any()
    again = tpinc.init_params(torch.Generator().manual_seed(0), (64, 64, 64, 64))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


def test_input_stats_match_jax(rng):
    z = _z(rng).astype(np.float32)
    for got, want in zip(tpinc.input_stats(torch.from_numpy(z)), jpinc.input_stats(jnp.asarray(z))):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # population standard deviation, floored at 1e-6 (the constant dt column)
    assert tpinc.input_stats(torch.from_numpy(z))[1][13] == np.float32(1e-6)


# --- losses -----------------------------------------------------------------------------------

def test_losses_match_jax(rng):
    jnet, params, tnet = _jnet(rng)
    z = _z(rng, 96).astype(np.float32)
    y = (rng.normal(size=(96, 9))).astype(np.float32)
    win = np.stack([_z(rng, 6) for _ in range(8)]).astype(np.float32)
    rp32 = tparams.reduced_params(device="cpu")
    pred = tnet(torch.from_numpy(z))
    jpred = jnet.apply(params, jnp.asarray(z))
    np.testing.assert_allclose(float(tpinc.mse_loss(pred, torch.from_numpy(y)).detach()),
                               float(jpinc.mse_loss(jpred, jnp.asarray(y))), rtol=1e-5)
    got = tpinc.physics_loss(rp32, pred, torch.from_numpy(z[:, 9:13]))
    want = jpinc.physics_loss(jparams.reduced_params(dtype=jnp.float32), jpred,
                              jnp.asarray(z[:, 9:13]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert got.requires_grad
    assert not tpinc.physics_loss(rp32, pred, torch.from_numpy(z[:, 9:13]), True).requires_grad
    np.testing.assert_allclose(float(tpinc.rollout_loss(tnet, torch.from_numpy(win), 5).detach()),
                               float(jpinc.rollout_loss(jnet, params, jnp.asarray(win), 5)),
                               rtol=1e-5)


# --- the optimizer ----------------------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 20, 43, 400])
def test_warmup_cosine_schedule_matches_optax(total):
    tc = tpinc.TrainConfig(lr_schedule="cosine")
    if total == 1:      # warmup 1 step, no decay steps: optax refuses too
        with pytest.raises(ValueError):
            jpinc.make_optimizer(jpinc.TrainConfig(lr_schedule="cosine"), total_steps=1)
        with pytest.raises(ValueError, match="decay_steps"):
            tpinc.make_optimizer(tc, [torch.zeros(1)], total_steps=1)
        return
    want = optax.warmup_cosine_decay_schedule(0.0, tc.lr, max(total // 20, 1), total, 0.01 * tc.lr)
    got = tpinc.warmup_cosine_schedule(tc.lr, total)
    assert got(0) == 0.0
    for c in range(total + 3):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-12, atol=1e-18)


@pytest.mark.parametrize("schedule", ["const", "cosine"])
@pytest.mark.parametrize("scale", [0.3, 30.0], ids=["clip_inactive", "clip_active"])
def test_adamw_clip_chain_matches_optax(schedule, scale, rng):
    shapes = {"a": (3, 4), "b": (5,), "c": ()}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(20)]
    norms = [math.sqrt(sum(float((g * g).sum()) for g in gs.values())) for gs in grads]
    assert all(n > 5.0 for n in norms) if scale > 1 else all(n < 5.0 for n in norms)
    opt = jpinc.make_optimizer(jpinc.TrainConfig(lr_schedule=schedule), total_steps=20)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = [torch.tensor(params[k]) for k in shapes]
    topt = tpinc.make_optimizer(tpinc.TrainConfig(lr_schedule=schedule), tp, total_steps=20)
    for step, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.tensor(g[k]) for k in shapes])
        for t, k in zip(tp, shapes):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} after step {step}")
    if schedule == "cosine":      # the first update had rate 0: nothing moved on step 0
        topt2 = tpinc.make_optimizer(tpinc.TrainConfig(lr_schedule="cosine"),
                                     [torch.tensor(params["a"])], total_steps=20)
        topt2.step([torch.tensor(grads[0]["a"])])
        assert torch.equal(topt2.params[0], torch.tensor(params["a"]))


# --- training ---------------------------------------------------------------------------------

def test_training_fed_jax_init_and_draws_matches_pinc_train(trained):
    net, hist = trc.pinc_train(trained)
    assert len(hist) == TRAIN["epochs"] and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, trained["hist"], rtol=1e-5)
    got = flat(convert.pinc_params_to_numpy(net)["params"], "params")
    want = {k: v for k, v in trained.items() if k.startswith("params.")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_guards_and_generator_draws(trained):
    data = tpinc.PINcData(*(torch.from_numpy(trained[k][:90].copy()) for k in ("z", "y", "u4")))
    g = torch.Generator().manual_seed(0)
    tc = tpinc.TrainConfig(epochs=2, batch=256, rollout_steps=5, rollout_windows=4,
                           physics_weight=0.0)
    net, hist = tpinc.train(g, data, tc, hidden=(8, 8))       # N < batch: clamped
    assert len(hist) == 2 and np.isfinite(hist).all() and net.hidden == (8, 8)
    assert tpinc.train(g, data, tc._replace(epochs=0), hidden=(8, 8))[1] == []
    tiny = tpinc.PINcData(*(t[:5] for t in data))          # N <= rollout_steps + 1: no rollout
    assert np.isfinite(tpinc.train(g, tiny, tc, hidden=(8, 8))[1]).all()
    perm, starts = tpinc.epoch_draws(torch.Generator().manual_seed(1), 89, 1, 89, tc)
    assert sorted(perm[0].tolist()) == list(range(89))
    assert starts.shape == (1, 4) and int(starts.max()) < 89 - 5 - 1


# --- inference --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_endpoint_rmse_and_simulate_match_jax(dtype, rng):
    jnet, params, tnet = _jnet(rng)
    tnet = tnet.to(TDTYPE[dtype])
    X12 = np.cumsum(rng.normal(size=(60, 12)) * 0.02, axis=0).astype(dtype)
    X12[:, 5] += 8.0                     # an unwound yaw: raw and ssa differ
    U4 = rng.normal(size=(60, 4)).astype(dtype)
    tX, tU, jX, jU = torch.from_numpy(X12), torch.from_numpy(U4), jnp.asarray(X12), jnp.asarray(U4)
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    for mode in ("raw", "ssa"):
        for H in (1, 7, 20):
            np.testing.assert_allclose(
                float(tpinc.endpoint_rmse(tnet, tX, tU, DT, H, mode)),
                float(jpinc.endpoint_rmse(jnet, params, jX, jU, DT, H, mode)), rtol=rtol,
                err_msg=f"{mode} H={H}")
    assert float(tpinc.endpoint_rmse(tnet, tX, tU, DT, 7, "ssa")) < \
        float(tpinc.endpoint_rmse(tnet, tX, tU, DT, 7, "raw"))
    for H in (60, 61):
        assert np.isnan(float(tpinc.endpoint_rmse(tnet, tX, tU, DT, H)))
    for bad in ("SSA", "wrapped"):
        with pytest.raises(ValueError, match="psi_error"):
            tpinc.endpoint_rmse(tnet, tX, tU, DT, 5, bad)
    got = tpinc.simulate(tnet, tX[3], tU[3:23], DT)
    want = np.asarray(jpinc.simulate(jnet, params, jX[3], jU[3:23], DT))
    assert got.shape == (21, 12)
    np.testing.assert_array_equal(got[0].numpy(), X12[3])
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)


def _reference_state_dict(rng, hidden=HIDDEN):
    """A state dict in the reference's ``nn.Sequential`` layout."""
    sd, width = {}, 14
    for i, h in enumerate(hidden):
        sd[f"net.{3 * i}.weight"] = torch.tensor(rng.normal(size=(h, width)) * 0.3, dtype=torch.float32)
        sd[f"net.{3 * i}.bias"] = torch.tensor(rng.normal(size=h) * 0.1, dtype=torch.float32)
        sd[f"net.{3 * i + 1}.beta"] = torch.tensor(1.0 + 0.2 * rng.random(), dtype=torch.float32)
        sd[f"net.{3 * i + 2}.weight"] = torch.tensor(1 + 0.1 * rng.normal(size=h), dtype=torch.float32)
        sd[f"net.{3 * i + 2}.bias"] = torch.tensor(0.1 * rng.normal(size=h), dtype=torch.float32)
        width = h
    n = len(hidden)
    sd[f"net.{3 * n}.weight"] = torch.tensor(rng.normal(size=(9, width)) * 0.1, dtype=torch.float32)
    sd[f"net.{3 * n}.bias"] = torch.tensor(rng.normal(size=9) * 0.01, dtype=torch.float32)
    return sd


def test_load_torch_checkpoint_matches_jax_import(tmp_path, rng):
    path = tmp_path / "pinc_best.pt"
    torch.save(_reference_state_dict(rng), path)
    jnet, jp = jpinc.load_torch_checkpoint(path, HIDDEN)
    tnet = tpinc.load_torch_checkpoint(path, HIDDEN, device="cpu")
    assert tnet.ln_eps == 1e-5 and tnet.norm_mu is None
    z = _z(rng).astype(np.float32)
    np.testing.assert_allclose(tnet(torch.from_numpy(z)).detach().numpy(),
                               np.asarray(jnet.apply(jp, jnp.asarray(z))), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="does not match"):
        tpinc.load_torch_checkpoint(path, (16, 16, 16), device="cpu")


def test_load_torch_checkpoint_full_module_requires_opt_in(tmp_path, rng):
    path = tmp_path / "module.pt"
    module = tpinc.PINcNet(HIDDEN, ln_eps=1e-5)
    module.load_state_dict(_reference_state_dict(rng))
    torch.save(module, path)
    for load in (lambda **kw: tpinc.load_torch_checkpoint(path, HIDDEN, device="cpu", **kw),
                 lambda **kw: jpinc.load_torch_checkpoint(path, HIDDEN, **kw)):
        with pytest.raises(ValueError, match="allow_full_unpickle"):
            load()
    net = tpinc.load_torch_checkpoint(path, HIDDEN, device="cpu", allow_full_unpickle=True)
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 module.state_dict().values()))

"""Train: epochs of PINc training, the physics-informed residual network.

The program side is ``models/pinc.py::train_from_draws``, the call that
``pinc.train`` and T6 (``apps/tank_full_comparison.py`` with no
checkpoint) make after their draws: minibatches of the recording's
training pairs (``pinc.make_dataset``), the one-step MSE, the reduced
model's physics residual and a multi-step rollout loss, a global-norm clip
and AdamW.  The initial weights and each epoch's permutation and window
starts are drawn once in set-up from the seed, with plain ``torch`` calls,
so every request trains the same epochs from the same start.  A request
is ``epochs_per_request`` epochs (one of the user's 200), ended by reading
the loss history back and a synchronise.  The reduced model's
coefficients reach the program from the configuration file.

An epoch of Adam steps is chaotic: rounding grows until float32 and
float64 trainings end a fifth of an epoch's move apart.  So besides the
requests' epochs, the comparison holds one short training after the
window, on the first ``first_steps`` minibatches, where rounding has not
grown yet.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from portbench import pinc_ops, recording
from portbench.kinds import Task
from portbench.reference import fossen as ref
from portbench.reference import pinc as rp

REDUCED_FIELDS = ("X_ud", "Y_vd", "Z_wd", "N_rd", "I_zz", "X_u", "Y_v", "Z_w", "N_r",
                  "X_uc", "Y_vc", "Z_wc", "N_rc")


def nominal_actuation(cfg: dict, device):
    """The port's ``(ThrusterConfig, LagParams)`` for the configuration's
    dt; raises ``ValueError`` where the file's thrusters or lag differ from
    them (the port builds only its nominal set)."""
    from bluerov2_dynamics_tpu_torch.models import params

    th64 = params.thruster_config(dtype=torch.float64, device="cpu")
    lag64 = params.lag_params(cfg["dt"], dtype=torch.float64, device="cpu")
    Ad, Bd, c = ref.zoh_lag(cfg, cfg["dt"])
    same = (torch.allclose(ref.wrench_map(cfg), th64.wrench_map, rtol=0, atol=1e-12)
            and tuple(cfg["thrusters"]["t200_curve_odd"]) == tuple(params.T200_CURVE)
            and torch.allclose(Ad, lag64.Ad, rtol=1e-12, atol=1e-14)
            and torch.allclose(Bd, lag64.Bd, rtol=1e-12, atol=1e-14)
            and torch.equal(c, lag64.c))
    if not same:
        raise ValueError(f"{cfg['name']}: thrusters or lag differ from the port's nominal set")
    return (params.thruster_config(device=device),
            params.lag_params(cfg["dt"], device=device))


def reduced_params(cfg: dict, device):
    """The program's ``ReducedParams`` from the configuration's ``reduced``
    block, in float32 on ``device``."""
    from bluerov2_dynamics_tpu_torch.models.params import ReducedParams

    c, g = cfg["reduced"], cfg["g"]
    put = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
    return ReducedParams(m=put(c["m"]), g=put(g), F_buoy=put(c["rho"] * c["volume"] * g),
                         **{k: put(c[k]) for k in REDUCED_FIELDS})


# the standard deviation of N(0, 1) cut at +-2
TRUNC_STD = 0.87962566103423978


def initial_weights(cfg: dict, gen: torch.Generator) -> list:
    """The net's initial parameters in the reference's order
    (``reference/pinc.py::param_shapes``), float32 on ``gen``'s device: each
    kernel LeCun truncated-normal (``N(0, 1)`` cut at 2 standard deviations,
    rescaled to ``1 / sqrt(fan_in)``), biases 0, beta the file's
    ``beta_init``, LayerNorm scale 1 and bias 0."""
    net = cfg["pinc"]
    put = lambda shape, v: torch.full(shape, float(v), device=gen.device)  # noqa: E731

    def kernel(n_out, n_in):
        w = torch.empty(n_out, n_in, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(1.0 / (math.sqrt(n_in) * TRUNC_STD))

    params, width = [], int(net["input_width"])
    for h in net["hidden"]:
        params += [kernel(h, width), put((h,), 0.0), put((), net["beta_init"]),
                   put((h,), 1.0), put((h,), 0.0)]
        width = h
    out = int(net["output_width"])
    return params + [kernel(out, width), put((out,), 0.0)]


def epoch_draws(gen: torch.Generator, N: int, batches: int, batch: int, windows: int,
                steps: int):
    """One epoch's ``(perm (batches, batch), starts (batches, windows))``: a
    permutation of the ``N`` pairs cut to whole minibatches, and each
    minibatch's rollout windows' first rows in ``[0, N - steps - 1)``."""
    perm = torch.randperm(N, generator=gen, device=gen.device)[:batches * batch]
    starts = torch.randint(0, N - steps - 1, (batches, windows), generator=gen,
                           device=gen.device)
    return perm.reshape(batches, batch), starts


def train_config(cfg: dict, traffic: dict):
    """The program's ``TrainConfig``: the configuration's optimiser, loss
    and input settings, the traffic's batch and rollout windows; raises
    ``ValueError`` where the file asks for what the port's AdamW fixes."""
    from bluerov2_dynamics_tpu_torch.models import pinc

    tr = cfg["training"]
    fixed = pinc.AdamWClip([], 0.0, 0.0)
    if (tr["b1"], tr["b2"], tr["eps"], tr["weight_decay"]) != (
            fixed.b1, fixed.b2, fixed.eps, fixed.weight_decay):
        raise ValueError(f"{cfg['name']}: AdamW's b1, b2, eps or weight decay differ "
                         "from the port's")
    return pinc.TrainConfig(
        epochs=int(tr["epochs"]), batch=int(traffic["batch"]), lr=float(tr["lr"]),
        clip_norm=float(tr["clip_norm"]), physics_weight=float(tr["physics_weight"]),
        physics_stop_gradient=not tr["physics_gradient"],
        rollout_steps=int(traffic["rollout_steps"]),
        rollout_windows=int(traffic["rollout_windows"]),
        rollout_weight=float(tr["rollout_weight"]), normalize=bool(tr["normalize"]),
        position_invariant=bool(tr["position_invariant"]), lr_schedule=tr["lr_schedule"])


class Train(Task):
    e2e = ("solve_s",)
    warmup = 0

    def setup(self):
        from bluerov2_dynamics_tpu_torch.models import pinc

        net_cfg, tr = self.cfg["pinc"], self.traffic
        if (int(net_cfg["input_width"]), int(net_cfg["output_width"])) != (14, 9):
            raise ValueError(f"{self.cfg['name']}: PINc takes 14 inputs to 9 outputs")
        X, U = recording.generate(self.cfg, tr, self.seed)
        X, U = recording.split(tr, X, U)
        self.X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        self.U = torch.as_tensor(U, dtype=torch.float32, device=self.device)
        thrusters, lag = nominal_actuation(self.cfg, self.device)
        self.rp = reduced_params(self.cfg, self.device)
        self.tc = train_config(self.cfg, tr)
        self.data = pinc.make_dataset(self.X, self.U, self.cfg["dt"], thrusters, lag)
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.params0 = initial_weights(self.cfg, gen)
        self.net0 = pinc.PINcNet(net_cfg["hidden"], np.zeros(14), np.ones(14),
                                 self.tc.position_invariant, float(net_cfg["ln_eps"]))
        self.net0 = self.net0.to(self.device)
        with torch.no_grad():
            for p, q in zip(self.net0.parameters(), self.params0, strict=True):
                if p.shape != q.shape:
                    raise ValueError(f"PINcNet holds {tuple(p.shape)} where the file's net "
                                     f"has {tuple(q.shape)}")
                p.copy_(q)
        N = self.data.z.shape[0]
        self.batches = N // self.tc.batch
        if not 0 < int(tr["first_steps"]) <= self.batches:
            raise ValueError(f"first_steps {tr['first_steps']} of an epoch of {self.batches} "
                             "minibatches")
        self.draws = [epoch_draws(gen, N, self.batches, self.tc.batch, self.tc.rollout_windows,
                                  self.tc.rollout_steps)
                      for _ in range(int(tr["epochs_per_request"]))]
        self.train(2)

    def first_draws(self) -> list:
        """The first epoch's first ``first_steps`` minibatches, each drawn as an
        epoch of its own, so that a training's history holds each one's loss."""
        perm, starts = self.draws[0]
        return [(perm[k:k + 1], starts[k:k + 1]) for k in range(int(self.traffic["first_steps"]))]

    def train(self, batches=None, draws=None):
        """One request: a copy of the initial net trained over the draws (their
        first ``batches`` minibatches), or over ``draws``; ``(net, history)``."""
        from bluerov2_dynamics_tpu_torch.models import pinc

        if draws is None:
            draws = [(p[:batches], s[:batches]) for p, s in self.draws]
        net, history = pinc.train_from_draws(copy.deepcopy(self.net0), self.data, draws,
                                             self.tc, rp=self.rp)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return net, history

    def window(self, seconds: float) -> dict:
        times, done = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            done.append(self.train())
            times.append(time.perf_counter() - t)
        net, history = self.train(draws=self.first_draws())
        first = (np.asarray(history), rp.flat(list(net.parameters())))
        z = self.data.z[:int(self.traffic["output_rows"])]
        with torch.no_grad():
            self.answers = [(np.asarray(history), rp.flat(list(net.parameters())),
                             net(z).double().cpu().numpy()) + first for net, history in done]
        n = len(times)
        return {"attempted": n, "wall_per_request_s": sum(times) / n,
                "e2e": {"solve_s": sum(times) / n}}

    def trace(self):
        from portbench.trace import profiled

        dev = self.device.type == "cuda"
        steps = self.traffic["trace_steps"]
        out = {f"fit{k}": profiled(lambda k=k: self.train(k), dev) for k in steps}
        out["window"] = out[f"fit{steps[-1]}"]
        return out

    def free(self):
        del self.data, self.net0

    def reference_answers(self, prec):
        data = rp.dataset(self.cfg, self.X, self.U, prec)
        steps = int(self.traffic["rollout_steps"])
        history, params = rp.train(self.cfg, self.params0, data, self.draws, steps, prec)
        first_history, first_params = rp.train(self.cfg, self.params0, data,
                                               self.first_draws(), steps, prec)
        z = data[0][:int(self.traffic["output_rows"])]
        with torch.no_grad():
            out = rp.forward(self.cfg, params, z, prec)
        return [(np.asarray(history), rp.flat(params), out.double().cpu().numpy(),
                 np.asarray(first_history), rp.flat(first_params), z)]

    def as_answers(self, ref_answers):
        return [a[:5] for a in ref_answers]

    def gaps(self, answers, ref_answers):
        """Per answer: ``loss_first_gap``, the largest relative gap of the
        first ``first_steps`` minibatches' losses (at the start and after
        each update); ``param_first_gap``, the distance of the parameters
        after those updates from the reference's over the length of the
        reference's change; ``loss_gap``, the largest relative gap of an
        epoch's mean loss; ``param_gap``, the same distance after the
        request's epochs (1 for parameters left at their start);
        ``output_gap``, the answer's predictions on the first rows against
        the float64 forward of the same trained parameters on the
        reference's rows, ``|x - x_ref| / max(1, |x_ref|)``."""
        want_l, want_p, _, want_l1, want_p1, z = ref_answers[0]
        theta0 = rp.flat(self.params0)

        def worst(g):
            return float(np.where(np.isfinite(g), g, np.inf).max())

        def rel(l, want):
            return worst(np.abs(l - want) / np.abs(want))

        def dist(p, want):
            return worst(np.linalg.norm(p - want) / np.linalg.norm(want - theta0))

        rows = []
        for l, p, o, l1, p1 in answers:
            with torch.no_grad():
                x = rp.forward(self.cfg, rp.unflat(self.cfg, p, z.device), z.double())
            x = x.cpu().numpy()
            rows.append(({"loss_first_gap": rel(l1, want_l1), "param_first_gap": dist(p1, want_p1),
                          "loss_gap": rel(l, want_l), "param_gap": dist(p, want_p),
                          "output_gap": worst(np.abs(o - x) / np.maximum(1.0, np.abs(x)))}, 1))
        return rows

    def shapes(self) -> dict:
        tr = self.traffic
        batches = self.batches * int(tr["epochs_per_request"])
        return {"steps": batches, "trace_steps": tuple(tr["trace_steps"]),
                "ops": pinc_ops.epoch_ops(self.cfg["pinc"], batches, int(tr["batch"]),
                                          int(tr["rollout_windows"]), int(tr["rollout_steps"]))}


TASK = Train

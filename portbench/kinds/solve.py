"""Solve: one identification fit of the Fossen coefficients.

The program side is ``models/sysid.py::fit_thruster``, the call behind the
apps' ``--fossen-fit``: the 23 Table A1 log-scales from zero, full-batch
Adam over every start of the recording's training split, the lag
warm-started from its history, one iteration captured as a CUDA graph and
replayed on the card.  A request is one whole fit, ended by a synchronise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import opcounts, recording
from portbench.kinds import Task
from portbench.reference import fossen as ref
from portbench.reference import tasks as rt

FIRST_LOSSES = 4          # the losses at theta_0 .. theta_3: the forward and three updates


class Solve(Task):
    e2e = ("solve_s",)
    warmup = 0

    def setup(self):
        X, U = recording.generate(self.cfg, self.traffic, self.seed)
        X, U = recording.split(self.traffic, X, U)
        self.X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        self.U = torch.as_tensor(U, dtype=torch.float32, device=self.device)
        self.fit(2)

    def fit(self, steps=None):
        from bluerov2_dynamics_tpu_torch.models import sysid

        tr = self.traffic
        return sysid.fit_thruster(
            self.X, self.U, self.cfg["dt"], horizon=int(tr["horizon"]),
            steps=int(tr["steps"]) if steps is None else steps, lr=float(tr["lr"]),
            method=tr["method"], input_delay=int(tr["input_delay"]),
            lag_warmup=bool(tr["lag_warm_start"]))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        times, answers = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            res = self.fit()
            self._sync()
            times.append(time.perf_counter() - t)
            answers.append((res.losses, res.log_scales))
        self.answers = [(l.double().cpu().numpy(), s.double().cpu().numpy())
                        for l, s in answers]
        n = len(times)
        return {"attempted": n, "wall_per_request_s": sum(times) / n,
                "e2e": {"solve_s": sum(times) / n}}

    def trace(self):
        from portbench.trace import profiled

        dev = self.device.type == "cuda"
        steps = self.traffic["trace_steps"]
        out = {f"fit{k}": profiled(lambda k=k: self.fit(k), dev) for k in steps}
        out["window"] = out[f"fit{steps[-1]}"]
        return out

    def reference_answers(self, prec):
        tr = self.traffic
        H, d = int(tr["horizon"]), int(tr["input_delay"])
        n = self.X.shape[0] - H - d
        lag0 = None
        if tr["lag_warm_start"]:
            hist = rt.lag_history(self.cfg, self.U.double().cpu().numpy())
            lag0 = torch.as_tensor(hist[d:d + n], device=self.device)
        losses, theta, g0 = rt.fit(self.cfg, self.X, self.U, H, int(tr["steps"]),
                                   float(tr["lr"]), tr["method"], d, lag0, prec)
        return [(losses, theta, g0)]

    def as_answers(self, ref_answers):
        return [(losses, theta) for losses, theta, _ in ref_answers]

    def gaps(self, answers, ref_answers):
        want_l, want_s, g0 = ref_answers[0]
        g = np.abs(g0)
        # coefficients whose gradient is nought to rounding in the reference
        # (the zero-valued nominal ones) move by round-off alone under Adam
        moving = g >= 1e-3 * np.median(g)
        self._still = int((~moving).sum())
        rows = []
        for losses, scales in answers:
            rel = np.abs(losses - want_l) / np.abs(want_l)
            rel = np.where(np.isfinite(rel), rel, np.inf)
            rows.append(({"loss_first_gap": float(rel[:FIRST_LOSSES].max()),
                          "loss_final_gap": float(rel[-1]),
                          "scales_gap": float(np.abs(scales - want_s)[moving].max())}, 1))
        return rows

    def notes(self) -> dict:
        return {"coefficients_still": getattr(self, "_still", 0)}

    def shapes(self) -> dict:
        tr = self.traffic
        H = int(tr["horizon"])
        n = self.X.shape[0] - H - int(tr["input_delay"])
        nnz = opcounts.wrench_nnz(ref.wrench_map(self.cfg))
        return {"n_start": n, "steps": int(tr["steps"]), "trace_steps": tuple(tr["trace_steps"]),
                "ops": opcounts.fit_ops(tr["method"], n, H, int(tr["steps"]), nnz)}


TASK = Solve

"""Scoring: one model scored by endpoint RMSE at each horizon.

The program side is the tank apps' physics row as the apps build it:
``apps/tank_koopman.py::fossen_evaluator`` (euler12 under thruster
commands; K2 fused on the card) or ``apps/tank_wrench_quat.py::
fossen_quat_evaluator`` (quat13 under the body wrench; K5 fused), built once
for the nominal coefficients.  A request calls it at every horizon of the
traffic and reads each RMSE to the host, as the apps' metric tables do.
"""

from __future__ import annotations

import time
from array import array

import numpy as np
import torch

from portbench import opcounts, recording
from portbench.kinds import Task
from portbench.reference import fossen as ref
from portbench.reference import tasks as rt


class Score(Task):
    e2e = ("score_ms", "score_ms_p95")

    def setup(self):
        X, U = recording.generate(self.cfg, self.traffic, self.seed)
        X, U = recording.split(self.traffic, *recording.for_state(self.cfg, X, U))
        # the program and the reference read the same float32 values
        self.X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        self.U = torch.as_tensor(U, dtype=torch.float32, device=self.device)
        self.horizons = [int(h) for h in self.traffic["horizons"]]
        method = self.traffic["method"]
        if self.cfg["state"] == "euler12":
            from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator
            self.evaluator = fossen_evaluator(self.cfg["dt"], self.X, self.U, method=method,
                                              device=self.device)
        else:
            from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import fossen_quat_evaluator
            self.evaluator = fossen_quat_evaluator(self.cfg["dt"], self.X, self.U, method=method,
                                                   device=self.device)
        for _ in range(self.warmup):
            self.request()

    def request(self):
        return tuple(float(self.evaluator(H)) for H in self.horizons)

    def window(self, seconds: float) -> dict:
        # flat arrays, so that the window's bookkeeping adds no objects for
        # the garbage collector to walk
        times, answers = array("d"), array("d")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            answers.extend(self.request())
            times.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        self.answers = np.frombuffer(answers).reshape(-1, len(self.horizons))
        n = len(times)
        return {"attempted": n, "wall_per_request_s": wall / n,
                "e2e": {"score_ms": 1e3 * wall / n,
                        "score_ms_p95": 1e3 * float(np.percentile(times, 95))}}

    def trace(self):
        from portbench.trace import profiled

        n = int(self.traffic["trace_requests"])
        return {"window": profiled(lambda: [self.request() for _ in range(n)],
                                   self.device.type == "cuda"), "requests": n}

    def free(self):
        del self.evaluator

    def reference_answers(self, prec):
        method = self.traffic["method"]
        return np.array([[rt.window_rmse(self.cfg, self.X, self.U, H, method, prec)
                          for H in self.horizons]])

    def gaps(self, answers, ref_answers):
        got, counts = np.unique(answers, axis=0, return_counts=True)
        g = np.abs(got - ref_answers[0]) / np.abs(ref_answers[0])
        g = np.where(np.isfinite(g), g, np.inf).max(axis=1)
        return [({"rmse_gap": float(v)}, int(c)) for v, c in zip(g, counts)]

    def shapes(self) -> dict:
        N = self.X.shape[0]
        state, method = self.cfg["state"], self.traffic["method"]
        nnz = opcounts.wrench_nnz(ref.wrench_map(self.cfg))
        per = {H: dict(ops=opcounts.window_ops(state, method, N - H, H, nnz),
                       bytes=opcounts.window_bytes(state, N)) for H in self.horizons}
        return {"rows": N, "horizons": self.horizons, "per_horizon": per}


TASK = Score

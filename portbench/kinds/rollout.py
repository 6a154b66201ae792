"""Batched rollout: B starts advanced T steps under one command sequence.

The program side is ``ops/cuda_rollout.py::make_rollout_final_cuda`` (K1 on
the card, the prologue from commands to wrench folded in) for the nominal
coefficients.  The inputs are ``bench.py``'s headline draws, made on the
device from the seed: a pool of ``(x0 (B, 12), U (T, 8))`` cycled call after
call, with no synchronise between calls and one at the window's end.  The
answers checked are a seeded sample of calls and of rows in each.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import opcounts
from portbench.kinds import Task
from portbench.reference import fossen as ref
from portbench.reference import tasks as rt


class Rollout(Task):
    e2e = ("sim_steps_per_s",)

    def setup(self):
        tr = self.traffic
        self.B, self.T, self.method = int(tr["batch"]), int(tr["steps"]), tr["method"]
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2**63)
        P = int(tr["pool"])
        self.x0 = float(tr["x0_scale"]) * torch.randn(
            (P, self.B, 12), generator=gen, device=self.device)
        self.U = torch.clamp(float(tr["u_scale"]) * torch.randn(
            (P, self.T, 8), generator=gen, device=self.device), -tr["u_clip"], tr["u_clip"])
        from bluerov2_dynamics_tpu_torch.models.params import (
            fossen_params,
            lag_params,
            thruster_config,
        )
        from bluerov2_dynamics_tpu_torch.ops.cuda_rollout import make_rollout_final_cuda

        dt = self.cfg["dt"]
        self.roll = make_rollout_final_cuda(fossen_params(device=self.device),
                                            thruster_config(device=self.device),
                                            lag_params(dt, device=self.device), dt, self.method)
        chk = tr["check"]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**63, 7]))
        self.sample = set(rng.choice(int(chk["among_first"]), int(chk["calls"]),
                                     replace=False).tolist())
        self.rows = torch.as_tensor(np.sort(rng.choice(self.B, min(int(chk["rows"]), self.B),
                                                       replace=False)), device=self.device)
        for i in range(1 + self.warmup):
            self.roll(self.x0[i % P], self.U[i % P])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        P = self.x0.shape[0]
        kept = {}
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out = self.roll(self.x0[i % P], self.U[i % P])
            if i in self.sample:
                kept[i] = out
            i += 1
        kept[i - 1] = out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        self.answers = [(k, v[self.rows]) for k, v in sorted(kept.items())]
        return {"attempted": i, "wall_per_request_s": wall / i,
                "e2e": {"sim_steps_per_s": i * self.B * self.T / wall}}

    def trace(self):
        from portbench.trace import profiled

        P, n = self.x0.shape[0], int(self.traffic["trace_requests"])

        def calls():
            for i in range(n):
                self.roll(self.x0[i % P], self.U[i % P])

        return {"window": profiled(calls, self.device.type == "cuda"), "requests": n}

    def free(self):
        del self.roll

    def reference_answers(self, prec):
        P = self.x0.shape[0]
        pools = [k % P for k, _ in self.answers]
        x0 = torch.cat([self.x0[j][self.rows] for j in pools])
        U = torch.cat([self.U[j][:, None, :].expand(self.T, len(self.rows), 8) for j in pools],
                      dim=1)
        xT, cmin = rt.rollout_final(self.cfg, x0, U, self.method, prec)
        n = len(self.rows)
        return [(xT[i * n:(i + 1) * n], cmin[i * n:(i + 1) * n]) for i in range(len(pools))]

    def as_answers(self, ref_answers):
        return [(k, xT) for (k, _), (xT, _) in zip(self.answers, ref_answers)]

    def gaps(self, answers, ref_answers):
        limit_cos = float(self.check_params["gimbal_cos"])
        rows, self._gimbal = [], 0
        for (_, got), (want, cmin) in zip(answers, ref_answers):
            keep = cmin >= limit_cos
            self._gimbal += int((~keep).sum())
            d = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
            d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
            g = float(d[keep].max()) if bool(keep.any()) else 0.0
            rows.append(({"state_gap": g}, 1))
        return rows

    def notes(self) -> dict:
        return {"rows_compared": len(self.answers) * len(self.rows),
                "rows_near_gimbal": getattr(self, "_gimbal", 0)}

    def shapes(self) -> dict:
        nnz = opcounts.wrench_nnz(ref.wrench_map(self.cfg))
        return {"ops": opcounts.rollout_ops(self.method, self.B, self.T, nnz),
                "bytes": opcounts.rollout_bytes(self.B, self.T), "steps": self.B * self.T}


TASK = Rollout

"""Koopman scoring: one fitted model scored by endpoint RMSE at each horizon.

The program side is T2's Koopman row (``apps/tank_koopman.py``): a request
calls ``koopman.multistep_rmse(model, X, U, H, method)`` over every start of
the test split at each horizon of the traffic and reads each RMSE to the
host, as the app's metric table does.  The model is fitted once in set-up,
untimed, by the reference in float64 on the recording's training split from
the program's k-means++ seed rows for the seed, and cast to float32 as the
port's ``KoopmanModel``: the weights both sides score are the reference's
own, so a fault of the program's fit cannot make the propagation easier on
both sides alike (``koopman-fit`` holds the fit).  The window, its metrics
and the gaps are the ``score`` kind's; the reference propagates the same
float32 weights in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import koopman_ops as kops
from portbench.kinds import koopman_common as common
from portbench.kinds.score import Score
from portbench.reference import koopman as rk

SPANS = ("brov2.koopman.propagate",)


class KoopmanScore(Score):
    def setup(self):
        from bluerov2_dynamics_tpu_torch.models import koopman

        parts = common.splits(self.cfg, self.traffic, self.seed, self.device)
        self.X, self.U = parts[self.traffic["recording"]["part"]]
        X_fit, U_fit = parts[self.traffic["fit_part"]]
        self.horizons = [int(h) for h in self.traffic["horizons"]]
        self.method = self.traffic["method"]
        ref = rk.fit(self.cfg, X_fit, U_fit, common.seed_rows(self.cfg, X_fit, self.seed))
        self.model = rk.Model(*(t.float() for t in ref))
        fitted = koopman.KoopmanModel(
            centers=self.model.centers, A=self.model.A, B=self.model.B,
            gamma=torch.tensor(float(rk.settings(self.cfg)["gamma"]), device=self.device))
        self.multistep_rmse = lambda H: koopman.multistep_rmse(fitted, self.X, self.U, H,
                                                               method=self.method)
        for _ in range(self.warmup):
            self.request()

    def request(self):
        return tuple(float(self.multistep_rmse(H)) for H in self.horizons)

    def trace(self):
        n = int(self.traffic["trace_requests"])
        out = common.profiled(lambda: [self.request() for _ in range(n)],
                              self.device.type == "cuda", SPANS)
        out["requests"] = n
        return out

    def free(self):
        del self.multistep_rmse

    def reference_answers(self, prec):
        return np.array([[rk.endpoint_rmse(self.cfg, self.model, self.X, self.U, H, prec)
                          for H in self.horizons]])

    def shapes(self) -> dict:
        N = self.X.shape[0]
        n, r, k, d = common.widths(self.cfg)
        per = {H: dict(ops=kops.score_ops(N, H, k, n, r), prop_ops=kops.prop_ops(N - H, H, d, r),
                       prop_bytes=kops.prop_bytes(N - H, H, d, r)) for H in self.horizons}
        return {"rows": N, "horizons": self.horizons, "per_horizon": per}


TASK = KoopmanScore

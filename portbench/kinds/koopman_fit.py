"""Koopman fit: one EDMDc fit of the recording's training split a request.

The program side is ``models/koopman.py::fit`` as the T2 app calls it
(``apps/common.py::fit_koopman_from_args``): the generator re-seeded from the
seed, k-means++ seeding and the Lloyd rounds (``ops/kmeans.py``), the lift of
the snapshot pairs, the ridge normal equations formed and solved in float64.
A request ends in a synchronise.  Every request fits the same model; the
window keeps each distinct answer once, with its count.

The comparison starts from the program's k-means++ seed rows, the one
random draw the reference takes from the program.  In float32 a Lloyd round
assigns the few rows whose two nearest centers lie within the Gram
expansion's rounding (``eps |x|^2``, with ``|x|^2`` up to ~10^3 on the
recording's wound yaw) to either one, and each such flip moves later rounds:
at the cell's size a float32 fit's centers end up to ~0.6 of ``max(1, |c|)``
from float64's, where the TF32 control reads ~2, so the centers themselves
are a note (``PERF.md`` section 2).  What the flips leave nearly unmoved is
held: the float32 answer's RMSEs and its k-means objective against the
reference's own fit.  Beside them, the float32 answers against the
reference's normal equations on the answer's own centers, where no flip
reaches; the same ``koopman.fit`` run once in float64 from the same seed
rows (no row there lies within rounding of a tie; made after the memory
peak is read) against the reference's own fit; and the seed rows' objective
against that of a k-means++ draw the reference makes from a generator of its
own, which a draw without the D^2 weighting misses by far.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from portbench import koopman_ops as kops
from portbench.kinds import Task
from portbench.kinds import koopman_common as common
from portbench.reference import koopman as rk

SPANS = ("brov2.koopman.normal_eqns",)
SEED_STREAM = 0x5EED           # the reference's own k-means++ draw: seed + this


class Side(NamedTuple):
    """What the checks read of an answer beyond its model, made when asked:
    its float64 fit, and the seed rows its Lloyd rounds started from."""
    fit64: Callable
    seeds: Callable


def worst(t: torch.Tensor) -> float:
    """The largest entry of ``t``, or inf where any entry is not finite."""
    return float(t.max()) if bool(torch.isfinite(t).all()) else float("inf")


class KoopmanFit(Task):
    e2e = ("solve_s",)
    warmup = 2

    def setup(self):
        parts = common.splits(self.cfg, self.traffic, self.seed, self.device)
        self.X, self.U = parts[self.traffic["recording"]["part"]]
        self.X_check, self.U_check = parts[self.traffic["check_part"]]
        self.horizons = [int(h) for h in self.traffic["check_horizons"]]
        self.gen = torch.Generator(self.device)
        self._seeds = self._fit64 = None
        for _ in range(self.warmup):
            self.fit()

    def fit(self):
        model = common.program_fit(self.cfg, self.X, self.U, self.seed, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return rk.Model(model.centers, model.A, model.B)

    def window(self, seconds: float) -> dict:
        times, distinct = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            model = self.fit()
            times.append(time.perf_counter() - t)
            if distinct and all(torch.equal(a, b) for a, b in zip(model, distinct[-1][0])):
                distinct[-1][1] += 1
            else:
                distinct.append([model, 1])
        side = Side(self.program_fit64, self.seed_rows)
        self.answers = [(model, count, side) for model, count in distinct]
        n = len(times)
        return {"attempted": n, "wall_per_request_s": sum(times) / n,
                "e2e": {"solve_s": sum(times) / n}}

    def trace(self):
        n = int(self.traffic["trace_requests"])
        out = common.profiled(lambda: [self.fit() for _ in range(n)],
                              self.device.type == "cuda", SPANS)
        out["requests"] = n
        return out

    def program_fit64(self) -> rk.Model:
        """The program's fit in float64 from the seed rows (``init=``), made
        once."""
        from bluerov2_dynamics_tpu_torch.models import koopman

        if self._fit64 is None:
            kw = dict(common.fit_kwargs(self.cfg), init=self.seed_rows().double())
            m = koopman.fit(None, self.X.double(), self.U.double(), **kw)
            self._fit64 = rk.Model(m.centers, m.A, m.B)
        return self._fit64

    def seed_rows(self):
        if self._seeds is None:
            self._seeds = common.seed_rows(self.cfg, self.X, self.seed)
        return self._seeds

    def rmses(self, model: rk.Model, prec=rk.F64) -> list:
        return [rk.endpoint_rmse(self.cfg, model, self.X_check, self.U_check, H, prec)
                for H in self.horizons]

    def reference_answers(self, prec):
        """The reference's fit from the program's seed rows, its RMSEs, and
        its own k-means++ draw, all in ``prec``."""
        model = rk.fit(self.cfg, self.X, self.U, self.seed_rows(), prec)
        gen = torch.Generator(self.X.device).manual_seed(self.seed + SEED_STREAM)
        seeds = rk.kmeanspp(self.X, model.centers.shape[0], gen, prec)
        return [(model, self.rmses(model, prec), seeds)]

    def as_answers(self, ref_answers):
        return [(model, 1, Side(lambda model=model: model, lambda seeds=seeds: seeds))
                for model, _, seeds in ref_answers]

    def gaps(self, answers, ref_answers):
        """Per distinct answer, against the reference's own fit from the same
        seed rows (``want``): ``float32_rmse_gap``, the largest relative gap
        of the endpoint RMSEs at the check horizons (each model propagated
        in float64 by the reference); ``objective_gap``, the relative gap of
        the k-means objective of its centers on the training rows (float64).
        Against the reference's normal equations on the answer's own centers
        (``[A B]_ref``): ``ab_gap``, the largest ``|[A B] - [A B]_ref|`` over
        the largest ``|[A B]_ref|``; ``rmse_gap``, as above.  From the
        answer's side: ``float64_fit_gap``, its float64 fit against
        ``want``, the largest of its centers' ``|c - c_ref| / max(1,
        |c_ref|)``, its ``[A B]`` gap and its RMSE gap; ``seed_objective_gap``,
        the relative gap of its seed rows' objective to that of the
        reference's own k-means++ draw."""
        want, want_rmse, want_seeds = ref_answers[0]
        X, U = self.X.double(), self.U.double()

        def rel(a, b):
            return worst((a.double() - b.double()).abs()) / float(b.double().abs().max())

        def ab(model, ref):
            return rel(torch.cat([model.A, model.B], 1), torch.cat([ref.A, ref.B], 1))

        def centers(model):
            c = want.centers.double()
            return worst((model.centers.double() - c).abs() / c.abs().clamp(min=1.0))

        def rmse(got, ref):
            return worst(torch.tensor([abs(g - w) / w for g, w in zip(got, ref)]))

        def objective_gap(C, ref):
            got = rk.objective(X, C.double())
            return abs(got - ref) / ref if got == got else float("inf")

        want_j, seeds_j = rk.objective(X, want.centers.double()), rk.objective(X, want_seeds)
        side = answers[0][2]
        fit64 = side.fit64()
        g64 = max(centers(fit64), ab(fit64, want), rmse(self.rmses(fit64), want_rmse))
        g_seed = objective_gap(side.seeds(), seeds_j)
        rows, self._notes = [], {"distinct_answers": len(answers)}
        for model, count, _ in answers:
            own = rk.normal_equations(self.cfg, X, U, model.centers.double())
            got = self.rmses(model)
            rows.append(({"ab_gap": ab(model, own), "rmse_gap": rmse(got, self.rmses(own)),
                          "float64_fit_gap": g64, "float32_rmse_gap": rmse(got, want_rmse),
                          "objective_gap": objective_gap(model.centers, want_j),
                          "seed_objective_gap": g_seed}, count))
            self._notes["float32_centers_gap"] = max(self._notes.get("float32_centers_gap", 0.0),
                                                    centers(model))
        return rows

    def notes(self) -> dict:
        """The float32 answers' centers against the reference's own fit (as
        ``float64_fit_gap`` measures them), which the Lloyd rounds' flips set."""
        return getattr(self, "_notes", {})

    def shapes(self) -> dict:
        N = self.X.shape[0]
        n, r, k, d = common.widths(self.cfg)
        iters = common.fit_kwargs(self.cfg)["kmeans_iters"]
        return {"rows": N, "ops": kops.fit_ops(N, k, n, r, iters),
                "gram_ops": kops.gram_ops(N - 1, d, r), "gram_bytes": kops.gram_bytes(N - 1, d, r)}


TASK = KoopmanFit

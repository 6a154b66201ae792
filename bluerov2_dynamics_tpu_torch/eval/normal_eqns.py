"""How much the precision of the Koopman normal equations moves the fit.

The JAX package forms ``G^T G`` and ``G^T Y`` and solves them by Cholesky
in float32; the port (``models/koopman.py``) forms and solves them in
float64 from the same float32 lifts.  This script fits T2's model three
ways on one pseudo tank recording and prints the endpoint RMSEs at H =
1/10/100 of each against an all-float64 fit on the same centers:

* ``float32``: Gram, cross term and Cholesky in float32 (the JAX
  package's precision);
* ``float32 Gram, float64 solve``;
* ``port``: ``koopman.fit`` as the port runs it.

Run: ``python -m bluerov2_dynamics_tpu_torch.eval.normal_eqns [--steps N]
[--n-rbfs K] [--device cpu|cuda]`` (defaults: the T2 recording's 45,823
steps, 500 RBFs, ``cuda``).
"""

from __future__ import annotations

import argparse
import json

import torch

from bluerov2_dynamics_tpu_torch.data.synthetic import generate_tank_recording
from bluerov2_dynamics_tpu_torch.device import resolve_device
from bluerov2_dynamics_tpu_torch.models import koopman
from bluerov2_dynamics_tpu_torch.ops.kmeans import kmeans
from bluerov2_dynamics_tpu_torch.ops.lifting import rbf_lift
from bluerov2_dynamics_tpu_torch.ops.precision import full_f32

HORIZONS = (1, 10, 100)


@full_f32()
def _fit_at(X, U, centers, gamma, ridge, gram_dtype, solve_dtype):
    Z = rbf_lift(X[:-1], centers, gamma)
    G = torch.cat([Z, U[:-1]], dim=1).to(gram_dtype)
    gram, rhs = G.T @ G, G.T @ rbf_lift(X[1:], centers, gamma).to(gram_dtype)
    M = koopman._solve_normal_eqns(gram.to(solve_dtype), rhs.to(solve_dtype), ridge)
    d = Z.shape[1]
    return koopman.KoopmanModel(centers, torch.as_tensor(gamma, dtype=X.dtype, device=X.device),
                                M[:d].T.to(X.dtype), M[d:].T.to(X.dtype))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=45_823)
    ap.add_argument("--n-rbfs", type=int, default=500)
    ap.add_argument("--gamma", type=float, default=3.0)
    ap.add_argument("--ridge", type=float, default=0.1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = generate_tank_recording(0, n_steps=args.steps, device=device)
    split = int(0.8 * args.steps)
    X, U, Xt, Ut = ds.X[:split], ds.U[:split], ds.X[split:], ds.U[split:]
    centers, _ = kmeans(X, args.n_rbfs, 25, torch.Generator(device).manual_seed(0))
    d64 = lambda t: t.double()  # noqa: E731
    ref = _fit_at(d64(X), d64(U), d64(centers), args.gamma, args.ridge, torch.float64,
                  torch.float64)
    want = {H: float(koopman.multistep_rmse(ref, d64(Xt), d64(Ut), H)) for H in HORIZONS}
    fits = {
        "float32": (torch.float32, torch.float32),
        "float32 Gram, float64 solve": (torch.float32, torch.float64),
    }
    out = {"steps": args.steps, "n_rbfs": args.n_rbfs, "device": str(device),
           "float64 RMSE": want, "relative to float64": {}}
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    models = {k: _fit_at(X, U, centers, args.gamma, args.ridge, *v) for k, v in fits.items()}
    models["port"] = koopman.fit(None, X, U, args.n_rbfs, args.gamma, args.ridge, 0, init=centers)
    for name, m in models.items():
        out["relative to float64"][name] = {
            H: float(koopman.multistep_rmse(m, Xt, Ut, H)) / want[H] - 1.0 for H in HORIZONS}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""The pseudo tank recording every cell's inputs come from, made from a seed.

The pattern of the JAX package's synthetic generator, written here on the
host in float64 Python arithmetic: the euler12 thruster model with each of
the 23 identified coefficients scaled by a draw from ``1 +- jitter`` (so the
nominal model is not the generator), explicit Euler at the configuration's
dt, AR(1) commands with a slowly modulated differential yaw bias on T1-T4, a
depth hold and a roll/pitch hold on T5-T8, and Gaussian sensor noise on every
channel.  Row ``k`` holds the state at which command ``U[k]`` was issued, so
``X[k + 1]`` is the step from ``X[k]`` under ``U[k]`` (input delay 0, the
pairing of a real tank recording).

Every draw comes from ``numpy.random.SeedSequence([seed, tag])``, one stream
a purpose, so a seed gives the same recording on any machine.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import fossen as ref

TAGS = {"factors": 1, "x0": 2, "normals": 3, "noise": 4}


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, TAGS[tag]]))


def generate(cfg: dict, traffic: dict, seed: int):
    """``(X (N, 12), U (N, 8))`` float64 host arrays of the recording that
    ``traffic["recording"]`` describes, for the vehicle of ``cfg``."""
    rec = traffic["recording"]
    n, dt, jit = int(rec["rows"]), float(cfg["dt"]), float(rec["jitter"])
    factors = rng(seed, "factors").uniform(1.0 - jit, 1.0 + jit, ref.N_COEFFS)
    c = [a * f for a, f in zip(ref.nominal_coefficients(cfg), factors)]
    normals = rng(seed, "normals").standard_normal((n, 8)).tolist()
    x0 = 0.05 * rng(seed, "x0").standard_normal(12)

    m, vol, (Ix, Iy, Iz), add = c[0], c[1], c[2:5], c[5:11]
    Xu, Yv, Zw, Kp, Mq, Nr = add
    mx, my, mz = m - Xu, m - Yv, m - Zw
    minv = [1.0 / v for v in (mx, my, mz, Ix - Kp, Iy - Mq, Iz - Nr)]
    dl = [-v for v in c[11:17]]
    dq = [-v for v in c[17:23]]
    W, B = m * cfg["g"], cfg["rho"] * cfg["g"] * vol
    xb, yb, zb = cfg["cb"]
    cur = cfg["current_ned"]
    Wm = ref.wrench_map(cfg).tolist()
    Ad, Bd, cl = (t.tolist() for t in ref.zoh_lag(cfg, dt))
    c1, c3, c5, c7, c9 = cfg["thrusters"]["t200_curve_odd"]

    cmd = rec["commands"]
    alpha, sigma = float(cmd["ar1_alpha"]), float(cmd["ar1_noise"])
    yaw_amp, period = float(cmd["yaw_drive"]), float(cmd["yaw_period_s"])
    yaw = [math.copysign(1.0, Wm[j][5]) if Wm[j][5] != 0.0 else 0.0 for j in range(4)] + [0.0] * 4
    roll = [0.0] * 4 + [math.copysign(1.0, Wm[j][3]) if Wm[j][3] != 0.0 else 0.0
                        for j in range(4, 8)]
    pitch = [0.0] * 4 + [math.copysign(1.0, Wm[j][4]) if Wm[j][4] != 0.0 else 0.0
                         for j in range(4, 8)]
    clip = lambda v, lim: -lim if v < -lim else (lim if v > lim else v)  # noqa: E731

    X, U = [], []
    x = [float(v) for v in x0]
    L = [[0.0, 0.0, 0.0] for _ in range(8)]
    u_ar = [0.0] * 8
    for k in range(n):
        X.append(x)
        nk = normals[k]
        u_ar = [clip(alpha * u_ar[j] + sigma * nk[j], 1.0) for j in range(8)]
        bias = yaw_amp * (0.02 + 0.98 * math.sin(2.0 * math.pi * k * dt / period))
        depth = clip(0.25 * x[2] + 0.4 * x[8], 0.6)
        rcmd = clip(-x[3] - 0.4 * x[9], 0.4)
        pcmd = clip(-x[4] - 0.4 * x[10], 0.4)
        u = [clip(u_ar[j] + bias * yaw[j] + (depth if j >= 4 else 0.0) + rcmd * roll[j]
                  + pcmd * pitch[j], 1.0) for j in range(8)]
        U.append(u)
        # thrusters: curve, lag (read after the update), wrench map
        tau = [0.0] * 6
        for j in range(8):
            v = u[j]
            v2 = v * v
            F = v * (c1 + v2 * (c3 + v2 * (c5 + v2 * (c7 + v2 * c9))))
            l0, l1, l2 = L[j]
            n0 = Ad[0][0] * l0 + Ad[0][1] * l1 + Ad[0][2] * l2 + Bd[0] * F
            n1 = Ad[1][0] * l0 + Ad[1][1] * l1 + Ad[1][2] * l2 + Bd[1] * F
            n2 = Ad[2][0] * l0 + Ad[2][1] * l1 + Ad[2][2] * l2 + Bd[2] * F
            L[j] = [n0, n1, n2]
            Fd = cl[0] * n0 + cl[1] * n1 + cl[2] * n2
            w0, w1, w2, w3, w4, w5 = Wm[j]
            tau = [tau[0] + Fd * w0, tau[1] + Fd * w1, tau[2] + Fd * w2, tau[3] + Fd * w3,
                   tau[4] + Fd * w4, tau[5] + Fd * w5]
        # euler12 right-hand side under the perturbed coefficients
        sf, cf = math.sin(x[3]), math.cos(x[3])
        st, ct = math.sin(x[4]), math.cos(x[4])
        sp, cp = math.sin(x[5]), math.cos(x[5])
        R = ((cp * ct, -sp * cf + cp * st * sf, sp * sf + cp * cf * st),
             (sp * ct, cp * cf + sf * st * sp, -cp * sf + st * sp * cf),
             (-st, ct * sf, ct * cf))
        u_, v_, w_, p_, q_, r_ = x[6:12]
        vc = [R[0][i] * cur[0] + R[1][i] * cur[1] + R[2][i] * cur[2] for i in range(3)]
        nr = (u_ - vc[0], v_ - vc[1], w_ - vc[2], p_, q_, r_)
        C = (mz * w_ * q_ - my * v_ * r_,
             -mz * w_ * p_ + mx * u_ * r_,
             my * v_ * p_ - mx * u_ * q_,
             (Iz - Iy + Mq - Nr) * q_ * r_ + (Yv - Zw) * v_ * w_,
             (Ix - Iz + Nr - Kp) * p_ * r_ + (Zw - Xu) * u_ * w_,
             (Iy - Ix + Kp - Mq) * p_ * q_ + (Xu - Yv) * u_ * v_)
        k3 = R[2]
        g = (-(W - B) * k3[0], -(W - B) * k3[1], -(W - B) * k3[2],
             B * (yb * k3[2] - zb * k3[1]), B * (zb * k3[0] - xb * k3[2]),
             B * (xb * k3[1] - yb * k3[0]))
        nud = [(tau[i] - C[i] - (dl[i] + dq[i] * abs(nr[i])) * nr[i] - g[i]) * minv[i]
               for i in range(6)]
        a = q_ * sf + r_ * cf
        xd = (R[0][0] * u_ + R[0][1] * v_ + R[0][2] * w_,
              R[1][0] * u_ + R[1][1] * v_ + R[1][2] * w_,
              R[2][0] * u_ + R[2][1] * v_ + R[2][2] * w_,
              p_ + a * st / ct, q_ * cf - r_ * sf, a / ct, *nud)
        x = [x[i] + dt * xd[i] for i in range(12)]
    noise = rec["sensor_noise"]
    sig = np.repeat([noise["position"], noise["angle"], noise["velocity"],
                     noise["angular_rate"]], 3)
    X = np.asarray(X) + sig * rng(seed, "noise").standard_normal((n, 12))
    return X, np.asarray(U)


def split(traffic: dict, X, U):
    """The rows ``traffic["recording"]["part"]`` names: ``train`` (the first
    ``train_split`` share), ``test`` (the rest) or ``all``."""
    rec = traffic["recording"]
    cut = int(float(rec["train_split"]) * len(X))
    part = rec["part"]
    if part == "train":
        return X[:cut], U[:cut]
    if part == "test":
        return X[cut:], U[cut:]
    if part == "all":
        return X, U
    raise ValueError(f"unknown recording part {part!r}")


def euler_to_quat(X):
    """Z-Y-X Euler angles of ``X (N, 12)`` as unit quaternions ``(N, 4)``,
    scalar first (float64)."""
    h = 0.5 * X[:, 3:6]
    c1, s1 = np.cos(h[:, 0]), np.sin(h[:, 0])
    c2, s2 = np.cos(h[:, 1]), np.sin(h[:, 1])
    c3, s3 = np.cos(h[:, 2]), np.sin(h[:, 2])
    q = np.stack([c3 * c2 * c1 + s3 * s2 * s1, c3 * c2 * s1 - s3 * s2 * c1,
                  c3 * s2 * c1 + s3 * c2 * s1, s3 * c2 * c1 - c3 * s2 * s1], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def for_state(cfg: dict, X, U):
    """The recording in the configuration's input contract: euler12 under
    thruster commands as recorded; quat13 states under the body wrench of
    ``cfg["wrench_input"]``."""
    if cfg["state"] == "euler12":
        return X, U
    if cfg["state"] == "quat13":
        X13 = np.concatenate([X[:, 0:3], euler_to_quat(X), X[:, 6:12]], axis=1)
        return X13, U @ ref.effectiveness(cfg).numpy()
    raise ValueError(f"unknown state {cfg['state']!r}")

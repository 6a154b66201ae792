"""Quaternion functions (scalar-first Hamilton convention, natively batched).

Counterpart of ``bluerov2_dynamics_tpu/ops/quaternion.py``:
``q = [qw, qx, qy, qz]``, Hamilton product, ``q_dot = 0.5 q (x) [0, omega]``,
and the Z-Y-X Euler <-> quaternion conversions.  Quaternions are
``(..., 4)`` tensors and vectors ``(..., 3)``; every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import torch

_NORM_EPS = 1e-12


def _components(q):
    return q[..., 0], q[..., 1], q[..., 2], q[..., 3]


def quat_normalize(q, eps=_NORM_EPS):
    """Normalise quaternions; a norm below ``eps`` gives the identity."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    # built without an indexed write: under vmap that write copies a host
    # scalar, which a CUDA graph cannot capture
    identity = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])], dim=-1)
    small = n < eps
    return torch.where(small, identity, q / torch.where(small, torch.ones_like(n), n))


def quat_to_rotation_matrix(q, normalize=True):
    """Quaternion -> DCM R_{b->n}, shape ``(..., 3, 3)``."""
    if normalize:
        q = quat_normalize(q)
    qw, qx, qy, qz = _components(q)
    row0 = torch.stack(
        [1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qz * qw), 2.0 * (qx * qz + qy * qw)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (qx * qy + qz * qw), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qx * qw)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (qx * qz - qy * qw), 2.0 * (qy * qz + qx * qw), 1.0 - 2.0 * (qx * qx + qy * qy)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def quat_rotate(q, v):
    """Body vectors into NED, ``R_{b->n}(q) @ v``, for a unit ``q``."""
    qw, qx, qy, qz = _components(q)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    nx = (1.0 - 2.0 * (qy * qy + qz * qz)) * vx + 2.0 * (qx * qy - qz * qw) * vy + 2.0 * (qx * qz + qy * qw) * vz
    ny = 2.0 * (qx * qy + qz * qw) * vx + (1.0 - 2.0 * (qx * qx + qz * qz)) * vy + 2.0 * (qy * qz - qx * qw) * vz
    nz = 2.0 * (qx * qz - qy * qw) * vx + 2.0 * (qy * qz + qx * qw) * vy + (1.0 - 2.0 * (qx * qx + qy * qy)) * vz
    return torch.stack([nx, ny, nz], dim=-1)


def quat_rotate_inv(q, v):
    """NED vectors into body, ``R_{b->n}(q)^T @ v``."""
    qw, qx, qy, qz = _components(q)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    bx = (1.0 - 2.0 * (qy * qy + qz * qz)) * vx + 2.0 * (qx * qy + qz * qw) * vy + 2.0 * (qx * qz - qy * qw) * vz
    by = 2.0 * (qx * qy - qz * qw) * vx + (1.0 - 2.0 * (qx * qx + qz * qz)) * vy + 2.0 * (qy * qz + qx * qw) * vz
    bz = 2.0 * (qx * qz + qy * qw) * vx + 2.0 * (qy * qz - qx * qw) * vy + (1.0 - 2.0 * (qx * qx + qy * qy)) * vz
    return torch.stack([bx, by, bz], dim=-1)


def quat_multiply(q1, q2):
    """Hamilton product ``q1 (x) q2``."""
    w1, x1, y1, z1 = _components(q1)
    w2, x2, y2, z2 = _components(q2)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    """Conjugate (the inverse of a unit quaternion)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_exp(rotvec):
    """Rotation vector ``(..., 3)`` -> unit quaternion ``(..., 4)``.

    Taylor-guarded at zero (``cos(a/2) ~ 1 - a^2/8``, ``sin(a/2)/a ~
    1/2 - a^2/48``), so it is finite and differentiable at ``rotvec = 0``.
    """
    a2 = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
    small = a2 < 1e-12
    ang = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    s = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * ang) / ang)
    w = torch.where(small[..., 0], 1.0 - a2[..., 0] / 8.0, torch.cos(0.5 * ang[..., 0]))
    return torch.cat([w[..., None], rotvec * s], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector ``(..., 3)``, the inverse of
    :func:`quat_exp` on the shortest arc (the sign of ``qw`` is made
    non-negative first); first-order Taylor guard ``k ~ 2/qw`` at the
    identity."""
    w0 = q[..., :1]
    q = q * torch.sign(torch.where(w0 == 0.0, torch.ones_like(w0), w0))
    qw, qv = q[..., 0], q[..., 1:]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < 1e-14
    nv = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))[..., 0]
    ang = 2.0 * torch.atan2(nv, qw)
    k = torch.where(small[..., 0], 2.0 / torch.clamp(qw, min=1e-6), ang / nv)
    return qv * k[..., None]


def quat_derivative(q, omega_body):
    """``q_dot = 0.5 q (x) [0, p, q, r]``."""
    w, x, y, z = _components(q)
    p, qr, r = omega_body[..., 0], omega_body[..., 1], omega_body[..., 2]
    return 0.5 * torch.stack(
        [
            -x * p - y * qr - z * r,
            w * p + y * r - z * qr,
            w * qr - x * r + z * p,
            w * r + x * qr - y * p,
        ],
        dim=-1,
    )


def euler_to_quat(phi, theta, psi):
    """Z-Y-X Euler angles -> unit quaternion ``(..., 4)``."""
    c1, s1 = torch.cos(phi * 0.5), torch.sin(phi * 0.5)
    c2, s2 = torch.cos(theta * 0.5), torch.sin(theta * 0.5)
    c3, s3 = torch.cos(psi * 0.5), torch.sin(psi * 0.5)
    q = torch.stack(
        [
            c3 * c2 * c1 + s3 * s2 * s1,
            c3 * c2 * s1 - s3 * s2 * c1,
            c3 * s2 * c1 + s3 * c2 * s1,
            s3 * c2 * c1 - c3 * s2 * s1,
        ],
        dim=-1,
    )
    return quat_normalize(q)


def quat_to_euler(q):
    """Quaternion -> ``(phi, theta, psi)`` Z-Y-X Euler angles."""
    qw, qx, qy, qz = _components(quat_normalize(q))
    phi = torch.atan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    theta = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0))
    psi = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return phi, theta, psi


def quat_to_yaw(q):
    """Quaternion -> yaw angle."""
    qw, qx, qy, qz = _components(quat_normalize(q))
    return torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))

"""Lane-layout math: vectors/quaternions with the COMPONENT axis leading and
the environment batch trailing, (..., B).

Port of roboticsplayroompybullet_tpu/ops/lane.py. A "v3" is a tensor
(3, ..., B); a "quat" is (4, ...) in xyzw order (PyBullet convention); a
"mat33" is (3, 3, ...). Constant operands are python floats or tensors that
broadcast against the lanes (see fused_step._const).
"""
from __future__ import annotations

import torch

_SCALARS: dict = {}


def _bound(c, like: torch.Tensor) -> torch.Tensor:
    """A python-number bound as a 0-d tensor of like's dtype and device,
    copied there once (a tensor bound is returned as it is)."""
    if isinstance(c, torch.Tensor):
        return c
    key = (float(c), like.dtype, like.device)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(c, dtype=like.dtype,
                                         device=like.device)
    return t


# jnp.maximum / minimum / clip: the values of torch.clamp_min / clamp_max /
# clamp, with JAX's derivative at a tie (half of the gradient to each
# side), where torch.clamp passes all of it: an action at its bound and a
# joint at its limit sit exactly there, so the twin's Jacobians there are
# JAX's lane twin's
def maximum(x: torch.Tensor, c) -> torch.Tensor:
    return torch.maximum(x, _bound(c, x))


def minimum(x: torch.Tensor, c) -> torch.Tensor:
    return torch.minimum(x, _bound(c, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return minimum(maximum(x, lo), hi)


def dot(a, b):
    return (a * b).sum(0)


def cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def norm(a, eps=1e-12):
    return torch.sqrt(dot(a, a) + eps)


def quat_multiply(a, b):
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz])


def quat_conjugate(q):
    return torch.stack([-q[0], -q[1], -q[2], q[3]])


def quat_normalize(q, eps=1e-12):
    return q / torch.sqrt((q * q).sum(0) + eps)[None]


def quat_rotate(q, v):
    """Rotate v3 by quat: 2(u·v)u + (w²−u·u)v + 2w(u×v)."""
    u = q[:3]
    w = q[3]
    return (2.0 * dot(u, v)[None] * u
            + (w * w - dot(u, u))[None] * v
            + 2.0 * w[None] * cross(u, v))


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis, angle):
    """axis: constant (3,) sequence of floats; angle: lane scalar."""
    half = 0.5 * angle
    s = torch.sin(half)
    c = torch.cos(half)
    return torch.stack([float(axis[0]) * s, float(axis[1]) * s,
                        float(axis[2]) * s, c])


def quat_to_mat33(q):
    """(3,3,...) rotation matrix (body->world) from xyzw quat."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    return torch.stack([torch.stack([r00, r01, r02]),
                        torch.stack([r10, r11, r12]),
                        torch.stack([r20, r21, r22])])


def mat33_vec(M, v):
    """(3,3,...) @ v3."""
    return torch.stack([M[0, 0] * v[0] + M[0, 1] * v[1] + M[0, 2] * v[2],
                        M[1, 0] * v[0] + M[1, 1] * v[1] + M[1, 2] * v[2],
                        M[2, 0] * v[0] + M[2, 1] * v[1] + M[2, 2] * v[2]])


def quat_integrate(q, omega, dt):
    """Exponential-map update, mirroring spatial.quat_integrate."""
    angle = norm(omega)
    axis = omega / maximum(angle, 1e-9)[None]
    half = angle * (dt * 0.5)
    s = torch.sin(half)
    dq = torch.stack([axis[0] * s, axis[1] * s, axis[2] * s, torch.cos(half)])
    return quat_normalize(quat_multiply(dq, q))

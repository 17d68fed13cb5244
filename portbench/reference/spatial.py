"""Quaternion helpers over a trailing component axis (..., 4), xyzw.

Port of the part of roboticsplayroompybullet_tpu/ops/spatial.py that the
rewards, the observations and the play actor need. Euler conventions
reproduce pybullet.getEulerFromQuaternion / getQuaternionFromEuler
(extrinsic XYZ).
"""
from __future__ import annotations

import torch


def quat_normalize(q, eps=1e-12):
    return q / torch.sqrt((q * q).sum(-1, keepdim=True) + eps)


def quat_from_euler(rpy):
    """pybullet.getQuaternionFromEuler equivalent: (..., 3) roll, pitch,
    yaw → (..., 4) xyzw."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def quat_to_euler(q):
    """pybullet.getEulerFromQuaternion equivalent → (..., 3) roll, pitch, yaw."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr = 2.0 * (w * x + y * z)
    cosr = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr, cosr)
    # clip strictly inside ±1 (gimbal lock), as the JAX package does
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0 + 1e-7, 1.0 - 1e-7)
    pitch = torch.asin(sinp)
    siny = 2.0 * (w * z + x * y)
    cosy = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny, cosy)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate v by q (v_world = R(q) v_local)."""
    qv = q[..., :3]
    t = 2.0 * _cross(qv, v)
    return v + q[..., 3:4] * t + _cross(qv, t)


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis, angle):
    """axis (3,) or (..., 3), angle (...) → (..., 4)."""
    half = angle[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)

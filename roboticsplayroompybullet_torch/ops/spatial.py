"""Quaternion helpers over a trailing component axis (..., 4), xyzw.

Port of the part of roboticsplayroompybullet_tpu/ops/spatial.py that the
rewards need. Euler conventions reproduce pybullet.getEulerFromQuaternion
(extrinsic XYZ).
"""
from __future__ import annotations

import torch


def quat_normalize(q, eps=1e-12):
    return q / torch.sqrt((q * q).sum(-1, keepdim=True) + eps)


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

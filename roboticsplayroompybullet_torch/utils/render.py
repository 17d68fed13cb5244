"""Ray-primitive intersections (port of the part of
roboticsplayroompybullet_tpu/utils/render.py that the gripper
proprioception ray needs; the raycaster itself comes with item 1.14).

Batched over leading axes: o, d (..., 3); a box's center (..., 3), quat
(..., 4) and half extents (3,) broadcast against them.
"""
from __future__ import annotations

import torch

from ..ops import spatial as sp

_BIG = 1e9


def _ray_plane_z(o, d, z):
    """t of intersection with the plane z = z (_BIG if parallel/behind)."""
    dz = d[..., 2]
    t = (z - o[..., 2]) / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    return torch.where((t > 1e-4) & (torch.abs(dz) > 1e-9), t, _BIG)


def _ray_box(o, d, center, quat, half):
    """Oriented-box slab test → (t, normal_world), t = _BIG on a miss."""
    ol = sp.quat_rotate_inverse(quat, o - center)
    dl = sp.quat_rotate_inverse(quat, d)
    dl_safe = torch.where(torch.abs(dl) < 1e-9, 1e-9, dl)
    t1 = (-half - ol) / dl_safe
    t2 = (half - ol) / dl_safe
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = tmin.amax(-1)
    t_far = tmax.amin(-1)
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t = torch.where(t_near > 1e-4, t_near, t_far)
    t = torch.where(hit, t, _BIG)
    # face normal: the first axis of t_near, against the local direction
    ax = torch.argmax((tmin == t_near[..., None]).to(torch.float32), dim=-1)
    one_hot = torch.nn.functional.one_hot(ax, 3).to(o.dtype)
    n_local = -one_hot * torch.sign(torch.gather(dl, -1, ax[..., None]))
    return t, sp.quat_rotate(quat, n_local)

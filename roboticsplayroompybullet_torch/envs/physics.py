"""Articulated-object poses (port of art_box_pose from
roboticsplayroompybullet_tpu/envs/physics.py). The port carries one
physics, the lane twin of ops/fused_step.py and its kernel; the JAX vmap
oracle this module holds there is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.playroom import Scene
from ..ops import fused_step as fs
from ..ops import spatial as sp


def art_box_pose(scene: Scene, k: int, art_q: torch.Tensor):
    """World (pos (B, 3), quat (B, 4)) of articulated object k's frame at
    joint values art_q (B, 4)."""
    qk = art_q[:, k]
    anchor = fs.const_on(scene.art_anchor[k], art_q.device)
    axis = fs.const_on(scene.art_axis[k], art_q.device)
    if scene.art_is_revolute[k]:
        return anchor.expand(qk.shape[0], 3), sp.quat_from_axis_angle(axis,
                                                                      qk)
    quat = fs.const_on(np.array([0.0, 0.0, 0.0, 1.0]), art_q.device)
    return anchor + axis * qk[:, None], quat.expand(qk.shape[0], 4)

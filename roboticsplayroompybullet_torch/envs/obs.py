"""Observation pieces the MPC needs (port of part of
roboticsplayroompybullet_tpu/envs/obs.py).

The ee state comes from the lane FK of ops/fused_step.py, the one physics
the port carries; every function takes an EnvState with the batch leading.
calc_obs, the proprioception ray and the quaternion sign-continuity filter
come with the env core.
"""
from __future__ import annotations

import torch

from ..models.arms import ArmConfig
from ..models.kinetree import KineTree
from ..models.playroom import dial_to_0_1_range
from ..ops import fused_step as fs
from ..ops import lane as ln
from .config import EnvConfig
from .state import EnvState


def ee_state(tree: KineTree, arm: ArmConfig, q: torch.Tensor,
             qd: torch.Tensor):
    """EE site world pose + velocities (getLinkState equivalent) of q, qd
    (B, n_dof) → pos (B, 3), quat (B, 4), lin vel (B, 3), ang vel (B, 3)."""
    kin = fs.lane_fk_vel(tree, q.T, qd.T)
    par = tree.site_parent[arm.ee_site]
    pos, quat = fs._lane_site_pose(tree, kin.pos, kin.quat, arm.ee_site)
    quat = ln.quat_normalize(quat)      # spatial.transform_compose does
    vel = kin.lv[par] + ln.cross(kin.av[par], pos - kin.pos[par])
    return pos.T, quat.T, vel.T, kin.av[par].T


def environment_scalars(state: EnvState) -> torch.Tensor:
    """[drawer_y, door, button, dial∈0-1] (environments.py:781-791), (B, 4);
    the dial with dial_to_0_1_range's precedence bug."""
    a = state.art_q
    return torch.stack([a[:, 0], a[:, 1], a[:, 2],
                        dial_to_0_1_range(a[:, 3])], dim=-1)


def achieved_goal(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                  state: EnvState) -> torch.Tensor:
    """Achieved goal (B, ag_dim): the layouts of calc_obs's
    'achieved_goal' (environments.py:816-835) without the sign-continuity
    filter, which distance costs do not need."""
    if cfg.play:
        parts = []
        for o in range(cfg.num_objects):
            parts += [state.obj_pos[:, o], state.obj_quat[:, o]]
        parts.append(environment_scalars(state))
        return torch.cat(parts, dim=-1)
    if cfg.num_objects > 0:
        parts = []
        for o in range(cfg.num_objects):
            parts.append(state.obj_pos[:, o])
            if cfg.use_orientation:
                parts.append(state.obj_quat[:, o])
        return torch.cat(parts, dim=-1)
    return ee_state(tree, arm, state.q, state.qd)[0]

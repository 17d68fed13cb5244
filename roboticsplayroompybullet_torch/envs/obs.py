"""Observation assembly (port of roboticsplayroompybullet_tpu/envs/obs.py),
batched over a leading B.

Every function takes an EnvState with the batch leading; link kinematics
come from the lane FK of ops/fused_step.py (`lane_fk_vel`), the one physics
the port carries. Layouts mirror the reference's `instance.calc_state`
(environments.py:799-864):

  obs_quat  = [arm(pos [,pos_vel] [,orn] gripper)] + per-object
              [pos [,orn] [,vel]] + play scalars [drawer, door, button,
              dial∈0-1]
  achieved_goal: play → 7/obj + 4 (playRewardFunc layout); objects →
              pos(+orn); none → ee pos
  observation = [obs_quat[0:3], Euler(obs_quat[3:7]), obs_quat[7:]]: the
              re-encode is unconditional (environments.py:859), so it only
              decodes a real quaternion in the play layouts.
  quaternion sign continuity flips with the reference's hard-coded index
              pairs (environments.py:868-894), play mode only, once a
              previous observation exists.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.arms import ArmConfig
from ..models.kinetree import KineTree
from ..models.playroom import Scene, dial_to_0_1_range
from ..ops import fused_step as fs
from ..ops import lane as ln
from ..ops import spatial as sp
from .config import EnvConfig
from .state import EnvState


def _ee_lanes(tree: KineTree, arm: ArmConfig, kin: fs.LaneKin):
    """EE site pose + velocities of lane kinematics, components leading."""
    par = tree.site_parent[arm.ee_site]
    pos, quat = fs._lane_site_pose(tree, kin.pos, kin.quat, arm.ee_site)
    quat = ln.quat_normalize(quat)      # spatial.transform_compose does
    vel = kin.lv[par] + ln.cross(kin.av[par], pos - kin.pos[par])
    return pos, quat, vel, kin.av[par]


def ee_state(tree: KineTree, arm: ArmConfig, q: torch.Tensor,
             qd: torch.Tensor):
    """EE site world pose + velocities (getLinkState equivalent) of q, qd
    (B, n_dof) → pos (B, 3), quat (B, 4), lin vel (B, 3), ang vel (B, 3)."""
    kin = fs.lane_fk_vel(tree, q.T, qd.T)
    return tuple(x.T for x in _ee_lanes(tree, arm, kin))


def _bullet_joint_vector(arm: ArmConfig, q: torch.Tensor) -> torch.Tensor:
    """First 8 bullet-joint positions (environments.py:758), (B, 8): the
    arm's movable joints map to dofs 0-6 (Panda) or 0-5 (UR5); the rest
    read 0."""
    n = 7 if arm.name == "Panda" else 6
    return torch.cat([q[:, :n], q.new_zeros(q.shape[0], 8 - n)], dim=-1)


def _proprioception(cfg: EnvConfig, arm: ArmConfig, tree: KineTree,
                    kin: fs.LaneKin, state: EnvState,
                    scene: Scene) -> torch.Tensor:
    """Binary 'something between the prongs' (environments.py:720-743),
    (B,).

    UR5 only (the Panda reads −1). The reference's `rayTest`: the segment
    runs from the ee/wrist midpoint (:726) to just past the inter-pad
    midpoint (:727) and is tested against every non-gripper collider —
    block boxes, articulated-element boxes, static boxes and the ground
    plane. A hit with fraction ≤ 1 reads 1, else 0; the pads themselves
    are never tested (:736). The zero-size padding boxes of the
    articulated elements (JAX obs.py:113-115) are left out by the static
    tables rather than masked. All boxes meet the ray in one batched slab
    test (a few dozen kernels, not one set per box).
    """
    B = state.q.shape[0]
    if arm.name != "UR5":
        return state.q.new_full((B,), -1.0)
    from ..utils.render import _ray_box, _ray_plane_z
    from .physics import art_box_pose

    dev = state.q.device
    centers, _, _, _ = fs.lane_pad_kinematics(tree, arm, kin)
    avg_pad = (sum(centers[1:], centers[0]) / len(centers)).T   # (B, 3)
    ee_pos = _ee_lanes(tree, arm, kin)[0].T
    wrist_pos = kin.pos[int(tree.parent[tree.site_parent[arm.ee_site]])].T
    p1 = ee_pos - (ee_pos - wrist_pos) * 0.5                    # :726
    d = (avg_pad + (ee_pos - wrist_pos) * 0.2) - p1             # :727

    # every collider box as (B, n, 3) centres, (B, n, 4) quats and (n, 3)
    # half extents, tested in one batched slab test
    no = cfg.num_objects
    cs = [state.obj_pos[:, :no]]
    qs = [state.obj_quat[:, :no]]
    hs = [np.tile(np.asarray(scene.block_half, np.float32), (no, 1))]
    if scene.has_articulated:
        for k in range(4):
            real = [j for j in range(scene.art_boxes_pos.shape[1])
                    if np.all(np.asarray(scene.art_boxes_half[k, j]) > 0.0)]
            apos, aquat = art_box_pose(scene, k, state.art_q)
            aq = aquat[:, None].expand(B, len(real), 4)
            cs.append(apos[:, None] + sp.quat_rotate(aq, fs.const_on(
                scene.art_boxes_pos[k, real], dev)))
            qs.append(aq)
            hs.append(np.asarray(scene.art_boxes_half[k, real], np.float32))
    ns = scene.static_pos.shape[0]
    cs.append(fs.const_on(scene.static_pos, dev).expand(B, ns, 3))
    qs.append(fs.const_on(np.tile([0.0, 0.0, 0.0, 1.0], (ns, 1)),
                          dev).expand(B, ns, 4))
    hs.append(np.asarray(scene.static_half, np.float32))
    tmin = _ray_plane_z(p1, d, float(scene.plane_z))
    hs = np.concatenate(hs)
    if len(hs):
        t, _ = _ray_box(p1[:, None], d[:, None], torch.cat(cs, 1),
                        torch.cat(qs, 1), fs.const_on(hs, dev))
        tmin = torch.minimum(tmin, t.amin(-1))
    return (tmin <= 1.0).to(torch.float32)


def arm_obs(cfg: EnvConfig, tree: KineTree, arm: ArmConfig, scene: Scene,
            state: EnvState, kin: fs.LaneKin) -> Dict[str, torch.Tensor]:
    """The arm's part of the observation, each (B, k)."""
    pos, quat, vel, ang_vel = (x.T for x in _ee_lanes(tree, arm, kin))
    grip = (state.q[:, arm.gripper_state_dof]
            * arm.gripper_state_scale)[:, None]
    return dict(pos=pos, orn=quat, pos_vel=vel, orn_vel=ang_vel,
                gripper=grip, joints=_bullet_joint_vector(arm, state.q),
                proprioception=_proprioception(cfg, arm, tree, kin, state,
                                               scene))


def environment_scalars(state: EnvState) -> torch.Tensor:
    """[drawer_y, door, button, dial∈0-1] (environments.py:781-791), (B, 4);
    the dial with dial_to_0_1_range's precedence bug."""
    a = state.art_q
    return torch.stack([a[:, 0], a[:, 1], a[:, 2],
                        dial_to_0_1_range(a[:, 3])], dim=-1)


def _flip_quats(vec, last, pairs):
    """Sign-continuity filter (environments.py:868-894), one index pair at
    a time, per env; `pairs` are the reference's hard-coded indices."""
    for lo, hi in pairs:
        q = vec[:, lo:hi]
        flip = (torch.sign(q) == -torch.sign(last[:, lo:hi])).all(-1)
        vec = torch.cat([vec[:, :lo], torch.where(flip[:, None], -q, q),
                         vec[:, hi:]], dim=-1)
    return vec


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


def calc_obs(cfg: EnvConfig, tree: KineTree, arm: ArmConfig, scene: Scene,
             state: EnvState) -> Dict[str, torch.Tensor]:
    """The full observation dict, each (B, k) (gripper_proprioception
    (B,)); '_prev_obs' / '_prev_ag' are the continuity buffers for the
    caller to thread into EnvState."""
    kin = fs.lane_fk_vel(tree, state.q.T, state.qd.T)
    a = arm_obs(cfg, tree, arm, scene, state, kin)

    parts = [a["pos"]]
    if cfg.return_velocity:
        parts.append(a["pos_vel"])
    if cfg.use_orientation:
        parts.append(a["orn"])
    parts.append(a["gripper"])
    for o in range(cfg.num_objects):
        parts.append(state.obj_pos[:, o])
        if cfg.use_orientation:
            parts.append(state.obj_quat[:, o])
        if cfg.return_velocity:
            parts.append(state.obj_vel[:, o])
    if cfg.play:
        parts.append(environment_scalars(state))
    state_vec = torch.cat(parts, dim=-1)

    if cfg.play or cfg.num_objects > 0:
        ag = achieved_goal(cfg, tree, arm, state)
    else:
        ag = a["pos"]

    # quaternion sign continuity: play only, the reference's index pairs
    if cfg.play:
        obs_pairs = [(3, 7), (11, 15)]
        ag_pairs = [(3, 7)]
        if cfg.num_objects == 2:
            obs_pairs.append((19, 23))
            ag_pairs.append((10, 14))
        hp = state.has_prev[:, None]
        state_vec = torch.where(
            hp, _flip_quats(state_vec, state.prev_obs, obs_pairs), state_vec)
        ag = torch.where(hp, _flip_quats(ag, state.prev_ag, ag_pairs), ag)

    if cfg.num_objects > 0:
        orn = [a["orn"]] if cfg.use_orientation else []
        fps = torch.cat([a["pos"]] + orn + [a["gripper"], ag], dim=-1)
    else:
        fps = torch.cat([a["pos"], a["gripper"]], dim=-1)

    observation = torch.cat([state_vec[:, 0:3],
                             sp.quat_to_euler(
                                 sp.quat_normalize(state_vec[:, 3:7])),
                             state_vec[:, 7:]], dim=-1)
    return {
        "obs_quat": state_vec,
        "achieved_goal": ag,
        "desired_goal": state.goal,
        "controllable_achieved_goal": torch.cat([a["pos"], a["gripper"]],
                                                dim=-1),
        "full_positional_state": fps,
        "joints": a["joints"],
        "velocity": torch.cat([a["pos_vel"], a["orn_vel"]], dim=-1),
        "observation": observation,
        "gripper_proprioception": a["proprioception"],
        "_prev_obs": state_vec,
        "_prev_ag": ag,
    }

"""Stateful gym-style wrapper and the batched env (port of
roboticsplayroompybullet_tpu/envs/wrapper.py).

`PlayEnv` mirrors the reference `playEnv` surface (environments.py:58-314):
numpy in, numpy out, one env, its state on the card unless the caller
passes device="cpu". Its camera (`render`, obs["img"] while recording, the
sub-goal ghosts of `visualise_sub_goal`) renders on the env's device
(utils/render.py) and copies one uint8 frame to the host. `BatchedEnv`
steps B envs in lockstep, tensors in and out, on the same device rule.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..ops import fused_step as fs
from ..ops import lane as ln
from ..ops import spatial as sp
from ..utils import render as rnd
from ..utils import spaces
from . import core
from . import physics
from .config import EnvConfig, CATALOG
from .rewards import compute_reward as _compute_reward
from .state import EnvState


def _observation_spaces(cfg: EnvConfig):
    """Dict obs space mirroring environments.py:120-166 bound tables
    EXACTLY, quirks included:

      * `arm_lower_obs_lim` concatenates **env_upper_bound** (not lower)
        with the negated tail in BOTH orientation branches
        (environments.py:135,144) — a reference bug replicated for parity:
        the published lower observation bound on the ee position equals
        the upper one.
      * goal boxes are `env_range` bounds tiled num_goals times
        (environments.py:152-153) even for play envs, whose actual
        desired/achieved goals are 7·n_obj+4-D — the reference publishes
        the same mismatched 3·num_goals box.
      * `observation` bounds include the quaternion slot the actual
        observation re-encodes to Euler (environments.py:859), so the
        published box is one element wider than the returned vector.
    """
    env_lo = np.asarray(cfg.env_range_low, np.float32)
    env_hi = np.asarray(cfg.env_range_high, np.float32)
    obj_lo = np.asarray(cfg.obj_lower_bound, np.float32)
    obj_hi = np.asarray(cfg.obj_upper_bound, np.float32)
    if cfg.use_orientation:
        arm_hi = np.concatenate([env_hi, [1, 1, 1, 1, 0.04]])
        arm_lo = np.concatenate([env_lo, [-1, -1, -1, -1, -0.0]])
        arm_obs_hi = np.concatenate([env_hi, [1, 1, 1, 1, 1, 1, 1, 0.04]])
        # reference bug: env_UPPER bound in the lower obs lim (:135)
        arm_obs_lo = np.concatenate([env_hi,
                                     [-1, -1, -1, -1, -1, -1, -1, -0.0]])
        obj_obs_hi = np.concatenate([obj_hi, np.ones(7)])
        obj_obs_lo = np.concatenate([obj_lo, -np.ones(7)])
        obj_pos_hi = np.concatenate([env_hi, np.ones(4)])
        obj_pos_lo = np.concatenate([env_lo, -np.ones(4)])
    else:
        arm_hi = np.concatenate([env_hi, [0.04]])
        arm_lo = np.concatenate([env_lo, [-0.0]])
        arm_obs_hi = np.concatenate([env_hi, [1, 1, 1, 0.04]])
        # reference bug: env_UPPER bound in the lower obs lim (:144)
        arm_obs_lo = np.concatenate([env_hi, [-1, -1, -1, -0.0]])
        obj_obs_hi = np.concatenate([obj_hi, np.ones(3)])
        obj_obs_lo = np.concatenate([obj_lo, -np.ones(3)])
        obj_pos_hi, obj_pos_lo = env_hi, env_lo
    obs_hi = np.concatenate([arm_obs_hi] + [obj_obs_hi] * cfg.num_objects)
    obs_lo = np.concatenate([arm_obs_lo] + [obj_obs_lo] * cfg.num_objects)
    goal_hi = np.concatenate([env_hi] * cfg.num_goals)
    goal_lo = np.concatenate([env_lo] * cfg.num_goals)
    full_hi = np.concatenate([arm_hi] + [obj_pos_hi] * cfg.num_objects)
    full_lo = np.concatenate([arm_lo] + [obj_pos_lo] * cfg.num_objects)
    return spaces.Dict(
        desired_goal=spaces.Box(goal_lo, goal_hi),
        achieved_goal=spaces.Box(goal_lo, goal_hi),
        observation=spaces.Box(obs_lo, obs_hi),
        controllable_achieved_goal=spaces.Box(arm_lo, arm_hi),
        full_positional_state=spaces.Box(full_lo, full_hi),
    )


def _device(device) -> torch.device:
    """The env's device: the card unless the caller names another."""
    return torch.device("cuda" if device is None else device)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


class PlayEnv:
    """Single-instance, host-friendly wrapper (numpy in / numpy out); the
    state lives on `device` (the card unless "cpu" is asked for)."""

    metadata = {"render.modes": ["human", "rgb_array"],
                "video.frames_per_second": 60}

    def __init__(self, cfg: EnvConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.model = core.build_model(cfg)
        self.device = _device(device)
        high = np.asarray(cfg.action_high, np.float32)
        self.action_space = spaces.Box(-high, high)
        self.observation_space = _observation_spaces(cfg)
        self._max_episode_steps = cfg.max_episode_steps
        self._seed = seed
        self._gen: Optional[torch.Generator] = None
        self._state: Optional[EnvState] = None
        self.render_scene = False
        # render('human') headless analogue of the reference's live GUI
        # (environments.py:220-224): while render_scene is set, step()
        # streams a PNG frame to this path every `human_render_every`
        # steps for an external viewer to watch.
        self.human_render_path = os.environ.get(
            "PLAYROOM_HUMAN_RENDER",
            os.path.join(tempfile.gettempdir(), "playroom_human.png"))
        self.human_render_every = int(os.environ.get(
            "PLAYROOM_HUMAN_RENDER_EVERY", "5"))
        self._human_step_count = 0
        self._record_images = False
        self._sub_goal = None
        self._ghosts = None          # the sub-goal's ghosts on the device

    # -- gym surface ------------------------------------------------------
    def seed(self, seed=None):
        if seed is not None:
            self._seed = seed
            self._gen = None
        return [seed]

    def _generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = _generator(self.device, self._seed)
        return self._gen

    @staticmethod
    def _host(tensors: dict) -> dict:
        """One device→host copy of every (1, ...) tensor, batch dropped."""
        keys = list(tensors)
        flat = torch.cat([tensors[k].reshape(1, -1).to(torch.float32)
                          for k in keys], dim=-1)[0].cpu().numpy()
        out, i = {}, 0
        for k in keys:
            shape = tuple(tensors[k].shape[1:])
            n = int(np.prod(shape))
            out[k] = flat[i:i + n].reshape(shape)
            i += n
        return out

    def reset(self, o=None, vr=None):
        self._state, obs = core.reset(self.model, self._generator(), 1, o=o,
                                      device=self.device)
        return self._host(obs)

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float32)[None],
                            device=self.device)
        self._state, obs, r, info = core.step(self.model, self._state, a)
        out = self._host(dict(obs, _r=r, _s=info["is_success"],
                              _tp=info["target_poses"]))
        r, s, tp = out.pop("_r"), out.pop("_s"), out.pop("_tp")
        # 200x200 RGB when recording (environments.py:841-843)
        frame = self._render_frame() if self._record_images else None
        out["img"] = frame
        if self.render_scene:
            self._human_step_count += 1
            if self._human_step_count % max(self.human_render_every, 1) == 0:
                rnd.write_png(self.human_render_path, self._render_frame()
                              if frame is None else frame)
        return out, float(r), False, {"is_success": float(s),
                                      "target_poses": tp}

    def _ghost_arm_links(self, ee_pos, ee_quat):
        """(n_dof, 3) link positions of a ghost arm IK'd to the sub-goal
        ee pose — the skeleton analogue of the reference's ghost_panda
        (environments.py:619-631, reset_arm at the sub-goal :699-703): 16
        DLS iterations from the rest pose, the rest pose as the null-space
        pose (kinematics.ik_dls's damping and gain), on the env's device.
        ee_quat None holds the rest pose's ee orientation."""
        tree, arm = self.model.tree, self.model.arm
        rest = torch.zeros(tree.n_dof, 1, device=self.device)
        rest[:arm.n_arm, 0] = torch.as_tensor(np.asarray(arm.rest_pose,
                                                         np.float32))
        if ee_quat is None:
            pos, quat = fs.lane_fk_links(tree, rest)
            target_quat = ln.quat_normalize(
                fs._lane_site_pose(tree, pos, quat, arm.ee_site)[1])
        else:
            target_quat = torch.as_tensor(ee_quat, device=self.device)[:, None]
        target_pos = torch.as_tensor(ee_pos, device=self.device)[:, None]
        q = fs.lane_ik_dls(tree, arm, rest, target_pos, target_quat, iters=16)
        links, _ = fs.lane_fk_links(tree, q)
        return torch.stack(links)[..., 0].cpu().numpy()

    def _sub_goal_ghosts(self):
        """Ghost-body arrays from the stored sub-goal vector, mirroring
        the reference's ghost set (environments.py:606-717):
          * ghost ARM skeleton IK'd to the ee sub-goal (ghost_panda.urdf
            analogue) for full_positional/controllable kinds,
          * per-block translucent BOXES at the block sub-goal poses
            (rgba-0.5 GEOM_BOX ghosts, :668-679),
          * the door/drawer/button/dial collider boxes posed at the
            sub-goal joint values (ghost scene elements, :684-717).
        Returns numpy (spheres, boxes) tuples of JAX's fixed shapes; a
        slot of alpha 0 is empty."""
        cfg = self.cfg
        tree, scene = self.model.tree, self.model.scene
        n_dof = tree.n_dof
        nKb = scene.art_boxes_pos.shape[1]
        S = 3 * n_dof + 1
        NB = cfg.num_objects + 4 * nKb
        pos = np.zeros((S, 3), np.float32)
        rad = np.zeros((S,), np.float32)
        col = np.zeros((S, 3), np.float32)
        alp = np.zeros((S,), np.float32)
        bpos = np.zeros((NB, 3), np.float32)
        bquat = np.zeros((NB, 4), np.float32)
        bquat[:, 3] = 1.0
        bhalf = np.zeros((NB, 3), np.float32)
        bcol = np.zeros((NB, 3), np.float32)
        balp = np.zeros((NB,), np.float32)
        spheres = (pos, rad, col, alp)
        boxes = (bpos, bquat, bhalf, bcol, balp)
        if self._sub_goal is None:
            return spheres, boxes
        vec, kind = self._sub_goal
        vec = np.asarray(vec, np.float32)
        ag = None
        if kind in ("full_positional_state", "controllable_achieved_goal"):
            ee = vec[:3]
            eq = (vec[3:7] if (cfg.use_orientation
                               and kind == "full_positional_state"
                               and vec.shape[0] >= 7) else None)
            links = self._ghost_arm_links(ee, eq)
            i = 0
            for l in range(n_dof):
                p = int(tree.parent[l])
                a = links[p] if p >= 0 else np.asarray(tree.base_pos)
                b = links[l]
                for s in range(3):
                    f = (s + 1) / 3.0
                    pos[i] = a + f * (b - a)
                    rad[i], col[i], alp[i] = 0.045, rnd._ARM_COLOR, 0.35
                    i += 1
            pos[S - 1], rad[S - 1] = ee, 0.05
            col[S - 1], alp[S - 1] = rnd._ARM_COLOR, 0.4
            if kind == "full_positional_state":
                off = 8 if cfg.use_orientation else 4
                if vec.shape[0] > off:
                    ag = vec[off:]
        else:                            # achieved_goal-layout sub-goal
            ag = vec
        if ag is not None and cfg.num_objects > 0:
            per = 7 if (cfg.play or cfg.use_orientation) else 3
            ghost_half = np.asarray(scene.block_half) if cfg.play \
                else np.full(3, 0.03, np.float32)    # environments.py:670-673
            for o in range(cfg.num_objects):
                bpos[o] = ag[per * o: per * o + 3]
                if per == 7:
                    q = ag[per * o + 3: per * o + 7]
                    nq = np.linalg.norm(q)
                    bquat[o] = q / nq if nq > 1e-6 else (0, 0, 0, 1)
                bhalf[o] = ghost_half
                bcol[o] = rnd._BLOCK_COLORS[o % 2]
                balp[o] = 0.5                        # rgba alpha 0.5, :672
            if cfg.play and ag.shape[0] >= per * cfg.num_objects + 4:
                art = ag[per * cfg.num_objects:][:4].copy()
                art[3] = art[3] * 2.2    # undo dial_to_0_1_range (viz only)
                art_q = torch.as_tensor(art)[None]
                for k in range(4):
                    apos, aquat = physics.art_box_pose(scene, k, art_q)
                    for j in range(nKb):
                        slot = cfg.num_objects + k * nKb + j
                        half = np.asarray(scene.art_boxes_half[k, j])
                        if float(half.sum()) <= 0.0:
                            continue                 # padding slot
                        off3 = sp.quat_rotate(aquat, torch.as_tensor(
                            scene.art_boxes_pos[k, j]))
                        bpos[slot] = (apos + off3)[0].numpy()
                        bquat[slot] = aquat[0].numpy()
                        bhalf[slot] = half
                        bcol[slot] = rnd._ART_COLORS[k]
                        balp[slot] = 0.4
        return spheres, boxes

    def _ghost_inputs(self):
        """render_state's (ghosts, ghost_boxes) of the sub-goal, on the
        env's device, made once a sub-goal. Slots of alpha 0 are left out:
        blending one changes no pixel."""
        if self._ghosts is None:
            out = []
            for arrays in self._sub_goal_ghosts():
                keep = arrays[-1] > 0
                out.append(tuple(torch.as_tensor(a[keep], device=self.device)
                                 for a in arrays) if keep.any() else None)
            self._ghosts = tuple(out)
        return self._ghosts

    def _render_frame(self):
        """The state's (200, 200, 3) uint8 frame: rendered on the env's
        device, truncated to uint8 there, one copy to the host."""
        m = self.model
        g, gb = self._ghost_inputs()
        img = rnd.render_state(m.cfg, m.tree, m.arm, m.scene, self._state,
                               ghosts=g, ghost_boxes=gb)
        return (img[0] * 255).to(torch.uint8).cpu().numpy()

    def render(self, mode="human"):
        if mode == "human":
            self.render_scene = True
            return np.array([])
        if mode in ("rgb_array", "playback"):
            self._record_images = True
            if self._state is not None:
                return self._render_frame()

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        r = _compute_reward(self.cfg, torch.as_tensor(
            np.asarray(achieved_goal, np.float32)), torch.as_tensor(
            np.asarray(desired_goal, np.float32)))
        return r.numpy()

    def reset_goal_pos(self, goal=None):
        """goal=None resamples (environments.py:190-191, 492-516)."""
        self._state = core.reset_goal(self.model, self._state,
                                      self._generator(), goal)

    def visualise_sub_goal(self, sub_goal,
                           sub_goal_state="full_positional_state"):
        """Stores the sub-goal for the renderer, which draws the
        reference's full ghost set (environments.py:606-717): ghost arm
        skeleton (full_positional/controllable kinds), translucent block
        boxes, and the scene elements posed at the sub-goal joint values
        (see _sub_goal_ghosts)."""
        self._sub_goal = (np.asarray(sub_goal), sub_goal_state)
        self._ghosts = None

    def delete_sub_goal(self):
        self._sub_goal = None
        self._ghosts = None

    def reset_arm_joints(self, poses):
        """Hard-teleport the arm joints, bypassing dynamics — the
        reference's debug path (environments.py:558-563): writes q, zeroes
        the velocities, and re-seeds the servo targets so the next step
        holds the teleported pose."""
        poses = np.asarray(poses, np.float32)
        n_arm = self.model.arm.n_arm
        assert poses.shape[0] >= n_arm, (poses.shape, n_arm)
        q = self._state.q.clone()
        q[0, :n_arm] = torch.as_tensor(poses[:n_arm], device=q.device)
        self._state = self._state.replace(
            q=q, qd=torch.zeros_like(self._state.qd),
            ctrl_q=q[:, :n_arm].clone())

    def vr_activation(self, vr=None):
        raise NotImplementedError(
            "VR teleop's SHARED_MEMORY attach (environments.py:252-267) "
            "has no analogue here; drive this env from an external teleop "
            "process via tools/teleop_bridge_torch.py (JSON over stdio/TCP, "
            "state injection + step)")

    @property
    def instance(self):
        return self

    @property
    def state(self) -> EnvState:
        return self._state


class BatchedEnv:
    """B env instances stepped in lockstep on `device` (the card unless
    "cpu" is asked for), tensors in and out.

    obs/reward come back with a leading (B,) dim. Auto-reset is NOT
    applied; `done` is always False, matching the reference
    (environments.py:212-213)."""

    def __init__(self, cfg: EnvConfig, batch_size: int, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.batch = batch_size
        self.model = core.build_model(cfg)
        self.device = _device(device)
        self._seed = seed
        self._gen: Optional[torch.Generator] = None
        self._state = None

    def reset(self):
        if self._gen is None:
            self._gen = _generator(self.device, self._seed)
        self._state, obs = core.reset(self.model, self._gen, self.batch,
                                      device=self.device)
        return obs

    def step(self, actions):
        self._state, obs, r, info = core.step(self.model, self._state,
                                              actions)
        return obs, r, torch.zeros_like(r, dtype=torch.bool), info

    @property
    def state(self):
        return self._state


def make(env_id: str, batch_size: Optional[int] = None, seed: int = 0,
         device=None):
    """gym.make equivalent over the catalog
    (roboticsPlayroomPybullet/__init__.py:3-99): a PlayEnv, or with
    batch_size a BatchedEnv, on the card unless device says otherwise."""
    if env_id not in CATALOG:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(CATALOG)}")
    cfg = CATALOG[env_id]
    if batch_size is None:
        return PlayEnv(cfg, seed=seed, device=device)
    return BatchedEnv(cfg, batch_size, seed=seed, device=device)

"""Stateful gym-style wrapper and the batched env (port of
roboticsplayroompybullet_tpu/envs/wrapper.py).

`PlayEnv` mirrors the reference `playEnv` surface (environments.py:58-314):
numpy in, numpy out, one env, its state on the card unless the caller
passes device="cpu". `BatchedEnv` steps B envs in lockstep, tensors in and
out, on the same device rule. Camera images (`render`, the drawing of
`visualise_sub_goal`, obs["img"]) come with the raycaster port (ROADMAP
item 1.14); until then `render` raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import spaces
from . import core
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
        self._sub_goal = None

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
        out["img"] = None          # camera images: ROADMAP item 1.14
        return out, float(r), False, {"is_success": float(s),
                                      "target_poses": tp}

    def render(self, mode="human"):
        raise NotImplementedError(
            "rendering (utils/render.py's raycaster, PlayEnv.render, "
            "obs['img'] and the sub-goal ghosts) is not ported yet: ROADMAP "
            "item 1.14")

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
        """Stores the sub-goal for the renderer (drawn once rendering is
        ported, ROADMAP item 1.14)."""
        self._sub_goal = (np.asarray(sub_goal), sub_goal_state)

    def delete_sub_goal(self):
        self._sub_goal = None

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
            "process (state injection + step)")

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

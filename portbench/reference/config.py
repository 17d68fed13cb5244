"""Frozen env configuration + the preset catalog (port of
roboticsplayroompybullet_tpu/envs/config.py, numpy only).

Replaces the reference's ctor-kwarg threading (environments.py:64-117) and
env-subclass catalog (envList.py:8-140) with hashable frozen dataclasses the
jitted step function closes over — every `if cfg.x` resolves at trace time.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]

# action-space tables (environments.py:88-117)
POS_STEP = 0.015
ORN_STEP = 0.1


@dataclass(frozen=True)
class EnvConfig:
    arm: str = "Panda"                  # 'Panda' | 'UR5'
    num_objects: int = 0
    play: bool = False
    use_orientation: bool = False
    return_velocity: bool = True
    sparse: bool = True
    sparse_rew_thresh: float = 0.05
    fixed_gripper: bool = False
    action_type: str = "absolute_rpy"
    show_goal: bool = True
    # None for play envs, matching envList.py:33-107 (horizons are never
    # enforced by the env itself — done is always False,
    # environments.py:212-213; the value is advisory for wrappers)
    max_episode_steps: Optional[int] = 250
    env_range_low: Vec3 = (-0.18, -0.18, -0.05)
    env_range_high: Vec3 = (0.18, 0.18, 0.15)
    goal_range_low: Vec3 = (-0.18, -0.18, -0.05)
    goal_range_high: Vec3 = (0.18, 0.18, 0.05)
    obj_lower_bound: Vec3 = (-0.18, -0.18, -0.05)
    obj_upper_bound: Vec3 = (-0.18, -0.18, -0.05)
    # physics constants (environments.py:68-69, 485-490)
    fps: int = 300
    substeps: int = 12

    # ---- derived static properties -------------------------------------
    @property
    def dt(self) -> float:
        return 1.0 / self.fps

    @property
    def num_goals(self) -> int:
        return max(self.num_objects, 1)

    @property
    def scene_kind(self) -> str:
        """Scene selection (environments.py:236-242)."""
        if self.play:
            return "complex"
        return "default" if self.num_objects == 0 else "push"

    @property
    def n_arm(self) -> int:
        return 7 if self.arm == "Panda" else 6

    @property
    def action_dim(self) -> int:
        return len(self.action_high)

    @property
    def action_high(self) -> Tuple[float, ...]:
        """environments.py:88-117 action bound table."""
        at = self.action_type
        if at == "absolute_quat":
            if self.use_orientation:
                return (1.0, 1.0, 1.0, 1, 1, 1, 1, 1)
            return (1.0, 1.0, 1.0, 1)
        if at == "relative_quat":
            return (1, 1, 1, 1, 1, 1, 1, 1)
        if at == "relative_joints":
            return tuple([1.0] * self.n_arm + [1.0])
        if at == "absolute_joints":
            return tuple([6.0] * self.n_arm + [1.0])
        if at == "absolute_rpy":
            return (6, 6, 6, 6, 6, 6, 1)
        if at == "relative_rpy":
            return (1, 1, 1, 1, 1, 1, 1)
        # default relative cartesian (pos_step/orn_step)
        if self.use_orientation:
            return (POS_STEP, POS_STEP, POS_STEP, ORN_STEP, ORN_STEP,
                    ORN_STEP, 1.0)
        return (POS_STEP, POS_STEP, POS_STEP, 1.0)

    @property
    def goal_dim(self) -> int:
        if self.play:
            return 7 * self.num_objects + 4   # per-block pos+quat, 4 scalars
        return 3 * self.num_goals

    @property
    def obs_dim(self) -> int:
        """`obs_quat` layout dim (environments.py:804-836)."""
        arm = 3 + (3 if self.return_velocity else 0) \
            + (4 if self.use_orientation else 0) + 1
        per_obj = 3 + (4 if self.use_orientation else 0) \
            + (3 if self.return_velocity else 0)
        extra = 4 if self.play else 0   # drawer/door/button/dial scalars
        return arm + per_obj * self.num_objects + extra

    @property
    def ag_dim(self) -> int:
        if self.play:
            return self.goal_dim
        if self.num_objects == 0:
            return 3
        per = 7 if self.use_orientation else 3
        return per * self.num_objects


def _play_kwargs(arm, action_type, num_objects=1):
    """Shared play-variant preset (envList.py:28-140)."""
    return dict(
        arm=arm, num_objects=num_objects, play=True, use_orientation=True,
        return_velocity=False, action_type=action_type, show_goal=False,
        max_episode_steps=None,
        env_range_low=(-1.0, -1.0, -0.2), env_range_high=(1.0, 1.0, 1.0),
        goal_range_low=(-0.18, 0.0, 0.05), goal_range_high=(0.18, 0.3, 0.1),
        obj_lower_bound=(-0.18, 0.0, 0.05), obj_upper_bound=(0.18, 0.3, 0.1),
    )


# the 20 registered ids (roboticsPlayroomPybullet/__init__.py:3-99;
# pointMass3D-v0 is a dead registration in the reference — envs/__init__.py
# never exports pointMassEnv — and is intentionally omitted)
CATALOG = {
    "pandaReach-v0": EnvConfig(arm="Panda", num_objects=0),
    "pandaReach2D-v0": EnvConfig(
        arm="Panda", num_objects=0,
        env_range_low=(-0.18, -0.18, -0.07), env_range_high=(0.18, 0.18, 0.0),
        goal_range_low=(-0.18, -0.18, -0.06),
        goal_range_high=(0.18, 0.18, -0.05)),
    "pandaPush-v0": EnvConfig(
        arm="Panda", num_objects=1,
        env_range_low=(-0.18, -0.18, -0.055), env_range_high=(0.18, 0.18, -0.04),
        goal_range_low=(-0.1, -0.1, -0.06), goal_range_high=(0.1, 0.1, -0.05),
        obj_lower_bound=(-0.1, -0.1, -0.06), obj_upper_bound=(0.1, 0.1, -0.05)),
    "pandaPick-v0": EnvConfig(
        arm="Panda", num_objects=1,
        env_range_low=(-0.18, -0.18, -0.055), env_range_high=(0.18, 0.18, 0.2),
        goal_range_low=(-0.18, -0.18, 0.0), goal_range_high=(0.18, 0.18, 0.1),
        obj_lower_bound=(-0.18, -0.18, 0.0), obj_upper_bound=(0.18, 0.18, 0.1)),
    # the 2-obj pandaPlay uniquely deepens the obs-space z floor to -0.4
    # (envList.py:30); all other play variants use -0.2
    "pandaPlay-v0": EnvConfig(**{
        **_play_kwargs("Panda", "absolute_quat", 2),
        "env_range_low": (-1.0, -1.0, -0.4)}),
    "pandaPlay1Obj-v0": EnvConfig(**_play_kwargs("Panda", "absolute_quat")),
    "pandaPlayRel1Obj-v0": EnvConfig(**_play_kwargs("Panda", "relative_quat")),
    "pandaPlayJoints-v0": EnvConfig(**_play_kwargs("Panda", "relative_joints", 2)),
    "pandaPlayRelJoints1Obj-v0": EnvConfig(**_play_kwargs("Panda", "relative_joints")),
    "pandaPlayAbsJoints1Obj-v0": EnvConfig(**_play_kwargs("Panda", "absolute_joints")),
    "pandaPlayAbsRPY1Obj-v0": EnvConfig(**_play_kwargs("Panda", "absolute_rpy")),
    "pandaPlayRelRPY1Obj-v0": EnvConfig(**_play_kwargs("Panda", "relative_rpy")),
    "UR5Reach-v0": EnvConfig(arm="UR5", num_objects=0),
    "UR5Play1Obj-v0": EnvConfig(**_play_kwargs("UR5", "absolute_quat")),
    "UR5PlayRel1Obj-v0": EnvConfig(**_play_kwargs("UR5", "relative_quat")),
    "UR5PlayRelJoints1Obj-v0": EnvConfig(**_play_kwargs("UR5", "relative_joints")),
    "UR5PlayAbsJoints1Obj-v0": EnvConfig(**_play_kwargs("UR5", "absolute_joints")),
    "UR5PlayAbsRPY1Obj-v0": EnvConfig(**_play_kwargs("UR5", "absolute_rpy")),
    "UR5PlayRelRPY1Obj-v0": EnvConfig(**_play_kwargs("UR5", "relative_rpy")),
    # pandaPlay-v0 uses 2 objects; keep an explicit 2-obj rel-joints alias
    # matching pandaPlayJoints-v0's reference semantics above.
}

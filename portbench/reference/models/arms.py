"""Per-arm actuation/control tables + gripper contact geometry (port of
roboticsplayroompybullet_tpu/models/arms.py, numpy only).

Everything the reference hard-codes about each arm's control path lives here
as frozen constants:
  - rest poses & base placement: environments.py:356-373
  - per-joint control clamps + rate limits: environments.py:1013-1026
  - servo force (240 N·m): environments.py:1027-1029
  - gripper motor mapping: environments.py:1037-1073 (Panda fingers 9/10
    geared; UR5 Robotiq driver 18 / follower 20 / springs 12,15 /
    mimics 10,13)
  - gripper state scaling: environments.py:754-756 (UR5 ×23), 1043
    (Panda 0.04 − amount/25)

Reduced-DoF indexing (models/kinetree.py):
  Panda: dofs 0-6 arm, 7 = finger joint 9, 8 = finger joint 10.
  UR5:   dofs 0-5 arm, 6/8 = mimics (joints 10/13), 7/9 = springs
         (joints 12/15), 10 = left driver (18), 11 = right driver (20).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from . import kinetree

PI = math.pi


@dataclass(frozen=True)
class ArmConfig:
    name: str
    n_arm: int
    n_dof: int
    rest_pose: Tuple[float, ...]          # arm-dof subset
    ctrl_lower: Tuple[float, ...]         # goto_joint_poses local_ll
    ctrl_upper: Tuple[float, ...]         # goto_joint_poses local_ul
    rate_limit: Tuple[float, ...]         # per-control-step target increment
    servo_force: float                    # arm joint motors
    # gripper: (dof index, target scale, target offset, force) rows;
    # target = scale * amount + offset where `amount` is arm-specific
    gripper_dofs: Tuple[Tuple[int, float, float, float], ...]
    gripper_state_dof: int                # dof read out as 'gripper' obs
    gripper_state_scale: float
    grip_follower: Tuple[int, int, float]  # (follower_dof, leader_dof, force)
    # contact spheres: (site index, site-local offset xyz, radius);
    # offsets calibrated from the q=0 site frames (tools/calibrate notes):
    # both arms: −y_local = inward pad normal (mirrored for panda right),
    # +z_local = along the finger toward the grasp target
    pad_spheres: Tuple[Tuple[int, Tuple[float, float, float], float], ...]
    ee_site: int
    wrist_site: int


def _panda() -> ArmConfig:
    tree = kinetree.panda_tree()
    return ArmConfig(
        name="Panda", n_arm=7, n_dof=tree.n_dof,
        rest_pose=(-0.6, 0.437, 0.217, -2.09, 1.1, 1.4, 1.3),
        # environments.py:1015-1017
        ctrl_lower=(-0.6, -2.2, -3.0, -3.04878596, -PI, -PI, -PI),
        ctrl_upper=(3.0, 1.8, 0.5, -0.5002492, 3.0, 3.45266257, 2.40072908),
        rate_limit=(0.1, 0.1, 0.2, 0.2, 0.2, 0.2, 0.2),
        servo_force=240.0,
        # close_gripper Panda branch (environments.py:1042-1047):
        # target = 0.04 − amount/25 on both fingers, force 100
        gripper_dofs=((7, -1.0 / 25.0, 0.04, 100.0),
                      (8, -1.0 / 25.0, 0.04, 100.0)),
        gripper_state_dof=7, gripper_state_scale=1.0,
        grip_follower=(-1, -1, 0.0),
        # fingertip pads on the finger-link sites; ee plane at z_local 0.047
        pad_spheres=(
            (tree.site_index("finger_left"), (0.0, -0.0055, 0.038), 0.0085),
            (tree.site_index("finger_left"), (0.0, -0.0055, 0.050), 0.0085),
            (tree.site_index("finger_right"), (0.0, 0.0055, 0.038), 0.0085),
            (tree.site_index("finger_right"), (0.0, 0.0055, 0.050), 0.0085),
        ),
        ee_site=tree.site_index("ee"), wrist_site=tree.site_index("hand"),
    )


def _ur5() -> ArmConfig:
    tree = kinetree.ur5e_tree()
    # close_gripper UR5 branch (environments.py:1048-1073), amount=grip−0.2:
    #   driver (dof 10):    0.055·amount   force 100
    #   springs (7, 9):     0.5·amount     force 100
    #   mimics (6, 8):      0.8·amount     force 100
    #   follower (dof 11):  tracks driver's current position, force 1000
    return ArmConfig(
        name="UR5", n_arm=6, n_dof=tree.n_dof,
        rest_pose=(-1.50189075, -1.6291067, -1.87020409, -1.21324173,
                   1.57003561, 0.06970189),
        # environments.py:1019-1021
        ctrl_lower=(-2 * PI,) * 6,
        ctrl_upper=(-0.7, 2 * PI, -0.5, 2 * PI, 2 * PI, 2 * PI),
        rate_limit=(0.1, 0.1, 0.2, 0.2, 0.2, 0.2),
        servo_force=240.0,
        gripper_dofs=((10, 0.055, 0.0, 100.0),
                      (7, 0.5, 0.0, 100.0), (9, 0.5, 0.0, 100.0),
                      (6, 0.8, 0.0, 100.0), (8, 0.8, 0.0, 100.0)),
        gripper_state_dof=10, gripper_state_scale=23.0,
        grip_follower=(11, 10, 1000.0),
        # Robotiq pad inner faces; ee plane at z_local ≈ 0.062
        pad_spheres=(
            (tree.site_index("pad_left"), (0.0, -0.012, 0.036), 0.010),
            (tree.site_index("pad_left"), (0.0, -0.012, 0.056), 0.010),
            (tree.site_index("pad_right"), (0.0, -0.012, 0.036), 0.010),
            (tree.site_index("pad_right"), (0.0, -0.012, 0.056), 0.010),
        ),
        ee_site=tree.site_index("ee"), wrist_site=tree.site_index("wrist"),
    )


@lru_cache(maxsize=None)
def get_arm(name: str):
    """Returns (KineTree, ArmConfig) for 'Panda' | 'UR5'."""
    if name == "Panda":
        return kinetree.panda_tree(), _panda()
    if name == "UR5":
        return kinetree.ur5e_tree(), _ur5()
    raise NotImplementedError(name)

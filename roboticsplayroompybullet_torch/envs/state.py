"""EnvState: the immutable env-state record, as torch tensors.

Port of roboticsplayroompybullet_tpu/envs/state.py. Every field carries the
batch on its leading axis, as the JAX package's batched states do. `rng`
holds the JAX PRNG key words as int64 (torch has no full uint32 support);
interop.state_to_numpy gives them back as uint32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class EnvState:
    q: torch.Tensor          # (B, n_dof) arm+gripper joint positions
    qd: torch.Tensor         # (B, n_dof)
    ctrl_q: torch.Tensor     # (B, n_arm) current arm servo targets
    grip: torch.Tensor       # (B,) last gripper command [0,1]
    obj_pos: torch.Tensor    # (B, n_obj, 3) block positions
    obj_quat: torch.Tensor   # (B, n_obj, 4)
    obj_vel: torch.Tensor    # (B, n_obj, 3)
    obj_angvel: torch.Tensor  # (B, n_obj, 3)
    art_q: torch.Tensor      # (B, 4) drawer-y, door, button, dial
    art_qd: torch.Tensor     # (B, 4)
    goal: torch.Tensor       # (B, goal_dim)
    prev_obs: torch.Tensor   # (B, obs_dim) for quaternion sign continuity
    prev_ag: torch.Tensor    # (B, ag_dim)
    has_prev: torch.Tensor   # (B,) bool
    rng: torch.Tensor        # (B, 2) int64 key words
    t: torch.Tensor          # (B,) int32 control step counter

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

"""Trajectory costs for the MPC solver (port of
roboticsplayroompybullet_tpu/solver/cost.py).

The env's own rewards (envs/rewards.py) are sparse and cannot rank
rollouts, so the solver scores with a dense surrogate whose zero set
matches the sparse success set: weighted distances per goal element,
mirroring the 11-D play layout (playRewardFunc.py:9-14). Every function
takes any leading batch axes, so a planner scores its whole (n_envs, pop)
population in one call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..envs.config import EnvConfig
from ..ops import spatial as sp


class CostWeights(NamedTuple):
    block_xyz: float = 1.0
    block_rot: float = 0.1
    scalars: float = 1.0       # drawer/door/button/dial
    action: float = 1e-3
    terminal: float = 10.0     # extra weight on the final step


def goal_distance(cfg: EnvConfig, ag: torch.Tensor, g: torch.Tensor,
                  w: CostWeights = CostWeights()) -> torch.Tensor:
    """Dense distance between achieved and desired goal; ag (..., ag_dim)
    and g (..., goal_dim) broadcast against each other."""
    shape = torch.broadcast_shapes(ag.shape[:-1], g.shape[:-1])
    norm = torch.linalg.vector_norm
    if cfg.play:
        d = torch.zeros(shape, dtype=torch.float32, device=ag.device)
        idx = 0
        for _ in range(cfg.num_objects):
            d = d + w.block_xyz * norm(
                ag[..., idx:idx + 3] - g[..., idx:idx + 3], dim=-1)
            qa = sp.quat_normalize(ag[..., idx + 3:idx + 7])
            qg = sp.quat_normalize(g[..., idx + 3:idx + 7])
            # clip strictly inside ±1: arccos' gradient is infinite at 1,
            # and aligned quats (ag == g at reset) sit exactly there
            dot = torch.clamp(torch.abs((qa * qg).sum(-1)), 0.0, 1.0 - 1e-6)
            d = d + w.block_rot * 2.0 * torch.arccos(dot)
            idx += 7
        return d + w.scalars * torch.abs(
            ag[..., idx:idx + 4] - g[..., idx:idx + 4]).sum(-1)
    if cfg.num_objects > 0:
        d = torch.zeros(shape, dtype=torch.float32, device=ag.device)
        g_ag, g_dg = 0, 0
        stride = 3 + (4 if cfg.use_orientation else 0)
        for _ in range(cfg.num_goals):
            d = d + norm(ag[..., g_ag:g_ag + 3] - g[..., g_dg:g_dg + 3],
                         dim=-1)
            g_ag += stride
            g_dg += 3
        return d
    return norm(ag - g, dim=-1)


def trajectory_cost(cfg: EnvConfig, ags: torch.Tensor, goal: torch.Tensor,
                    actions: torch.Tensor,
                    w: CostWeights = CostWeights()) -> torch.Tensor:
    """Score rollouts: ags (..., H, ag), goal (..., goal_dim), actions
    (..., H, A) → (...) costs."""
    d = goal_distance(cfg, ags, goal[..., None, :], w)    # (..., H)
    stage = d.sum(-1) + w.terminal * d[..., -1]
    act = w.action * torch.square(actions).sum((-2, -1))
    return stage + act

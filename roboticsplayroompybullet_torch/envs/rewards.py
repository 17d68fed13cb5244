"""Reward / success functions (port of
roboticsplayroompybullet_tpu/envs/rewards.py).

  * play success: the all-or-nothing threshold test (playRewardFunc.py:9-77)
    — block xyz 0.05, block RPY π/4 on raw Euler differences, drawer 0.025,
    door 0.04, button 0.01, dial 0.3.
  * non-play sparse piecewise per-goal distance (environments.py:278-304)
    with the reference's ag stride of (3+4) per goal.
Dense reward: −‖ag − g‖ (environments.py:274-275).
"""
from __future__ import annotations

import math

import torch

from ..ops import spatial as sp
from .config import EnvConfig


def play_success(cfg: EnvConfig, ag: torch.Tensor, g: torch.Tensor):
    """0 if ALL elements within threshold else −1 (playRewardFunc.py:66-77);
    per-block xyz+RPY tests, then the 4 articulated scalars."""
    ok = torch.ones(torch.broadcast_shapes(ag.shape[:-1], g.shape[:-1]),
                    dtype=torch.bool, device=ag.device)
    idx = 0
    for _ in range(cfg.num_objects):
        dxyz = torch.abs(g[..., idx:idx + 3] - ag[..., idx:idx + 3])
        ok = ok & (dxyz <= 0.05).all(-1)
        g_rpy = sp.quat_to_euler(sp.quat_normalize(g[..., idx + 3:idx + 7]))
        ag_rpy = sp.quat_to_euler(sp.quat_normalize(ag[..., idx + 3:idx + 7]))
        ok = ok & (torch.abs(g_rpy - ag_rpy) <= math.pi / 4).all(-1)
        idx += 7
    # scalar thresholds: a tensor of them would be a host-to-device copy,
    # which waits for the card, on every call
    d = torch.abs(g[..., idx:idx + 4] - ag[..., idx:idx + 4])
    for j, thresh in enumerate((0.025, 0.04, 0.01, 0.3)):
        ok = ok & (d[..., j] <= thresh)
    return torch.where(ok, 0.0, -1.0)


def sparse_reward(cfg: EnvConfig, ag: torch.Tensor, g: torch.Tensor):
    """Piecewise per-goal: −1 if beyond threshold else −distance
    (environments.py:290-304). ag strides 3+4 per goal, g strides 3."""
    reward = torch.zeros(torch.broadcast_shapes(ag.shape[:-1], g.shape[:-1]),
                         dtype=ag.dtype, device=ag.device)
    g_ag = 0
    g_dg = 0
    for _ in range(cfg.num_goals):
        d = torch.linalg.vector_norm(
            ag[..., g_ag:g_ag + 3] - g[..., g_dg:g_dg + 3], dim=-1)
        reward = reward + torch.where(d > cfg.sparse_rew_thresh, -1.0, -d)
        g_ag += 3 + 4
        g_dg += 3
    return reward


def dense_reward(ag: torch.Tensor, g: torch.Tensor):
    return -torch.linalg.vector_norm(ag - g, dim=-1)


def compute_reward(cfg: EnvConfig, ag: torch.Tensor, g: torch.Tensor):
    if not cfg.sparse:
        return dense_reward(ag, g)
    if cfg.play:
        return play_success(cfg, ag, g)
    return sparse_reward(cfg, ag, g)

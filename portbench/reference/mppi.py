"""MPPI replans and the executed control step, in plain PyTorch over the
plain twin: a frozen copy of the port's `solver/mpc.py` sampling
(`_sample_from`) and update (`_mppi_update`), with the preview rollouts of
`make_fused_planner` and the executed step of `make_fused_batched_step`.

Several replans ride one batch: k states of one env each, with their own
plans and normals, preview as k · pop envs of the twin.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cost import CostWeights, trajectory_cost
from .rewards import compute_reward


class MPPIConfig(NamedTuple):
    horizon: int = 10
    pop: int = 1024
    iters: int = 2
    temperature: float = 0.05
    smooth: float = 0.7
    preview_ik_iters: int = 8
    preview_solve_iters: int = 8
    weights: CostWeights = CostWeights()


def sample_from(mean, sigma, cfg: MPPIConfig, noise, high):
    """The AR(1)/clip transform of standard normals noise (..., n, H, A)
    into n action sequences about mean (..., H, A), clipped to ±high;
    candidate 0 carries the unperturbed mean."""
    root = float(np.sqrt(np.float32(1.0 - cfg.smooth ** 2)))
    prev = torch.zeros_like(noise[..., 0, :])
    corr = []
    for h in range(noise.shape[-2]):
        prev = cfg.smooth * prev + root * noise[..., h, :]
        corr.append(prev)
    corr = torch.stack(corr, dim=-2)
    acts = mean[..., None, :, :] + sigma[..., None, :, :] * corr
    acts = torch.cat([mean[..., None, :, :], acts[..., 1:, :, :]], dim=-3)
    return torch.clamp(acts, -high, high)


def mppi_update(cfg: MPPIConfig, actions, costs):
    """Softmax-weighted mean over the samples: actions (..., n, H, A),
    costs (..., n) → (mean (..., H, A), best cost (...))."""
    best = costs.amin(-1, keepdim=True)
    w = torch.exp(-(costs - best) / cfg.temperature)
    wsum = w.sum(-1)
    wact = (w[..., None, None] * actions).sum(-3)
    return wact / torch.clamp_min(wsum, 1e-9)[..., None, None], best[..., 0]


def replan(plain, cfg: MPPIConfig, X, goal, mean, sigma, noises, high):
    """k replans at once. X (NF, k) the states, goal (k, goal_dim), mean /
    sigma (k, H, A) the plans the replans start from, noises [(k, pop, H,
    A)] one per iteration, high (A,) the action bound. Returns (mean (k, H,
    A), best cost (k,)) of the last iteration."""
    k, H, pop = X.shape[1], cfg.horizon, cfg.pop
    Xrep = X.repeat_interleave(pop, dim=1)                  # (NF, k·pop)
    best = None
    for noise in noises:
        acts = sample_from(mean, sigma, cfg, noise, high)   # (k, pop, H, A)
        _, ags = plain.rollout(Xrep, acts.reshape(k * pop, H, -1)
                               .permute(1, 2, 0).contiguous(),
                               ik_iters=cfg.preview_ik_iters,
                               solve_iters=cfg.preview_solve_iters)
        ags = ags.permute(2, 0, 1).reshape(k, pop, H, -1)
        costs = trajectory_cost(plain.cfg, ags, goal[:, None, :], acts,
                                cfg.weights)
        mean, best = mppi_update(cfg, acts, costs)
    return mean, best


def execute(plain, X, actions, goal):
    """The executed control step of k envs: X (NF, k), actions (k, A) →
    (X' (NF, k), reward (k,))."""
    X2 = plain.step(X, actions.T.contiguous())
    return X2, compute_reward(plain.cfg, plain.ag(X2).T, goal)

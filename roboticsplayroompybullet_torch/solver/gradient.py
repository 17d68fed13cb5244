"""First-order trajectory refinement: Adam through the differentiable
rollout (port of roboticsplayroompybullet_tpu/solver/gradient.py, the
"SQP-lite" companion to solver/ilqr.py: cheaper per iteration, no
Hessians).

JAX takes the loss's gradient with value_and_grad through the vmap
oracle's rollout (parallel/rollout.py::rollout). Here `rollout` is its
differentiable counterpart (grad_step.rollout_states): the H steps run
forward through the `step` kernel on the card (the plain twin on the
CPU), all H are linearised at once through the plain twin (one batched
VJP of H·n copies, a CUDA graph replay on the card), and the backward is
the adjoint recursion: one VJP a gradient, where a per-step backward
would take H (7.8x the time on the H100, tools/time_grad_step.py). The
port's parallel/rollout.py::rollout stays the kernel-only light path,
with no backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..envs.core import EnvModel
from ..envs.obs import achieved_goal
from ..envs.rewards import compute_reward
from ..envs.state import EnvState
from ..ops import fused_step as fs
from ..ops import lane as ln
from ..ops.grad_step import rollout_states
from .cost import CostWeights, trajectory_cost
from .ilqr import _extract, _inject, make_flat_dynamics


class GradConfig(NamedTuple):
    iters: int = 50
    lr: float = 0.05
    weights: CostWeights = CostWeights()


def rollout(m: EnvModel, state: EnvState, actions: torch.Tensor):
    """One env (state of B=1) through an (H, A) action sequence → (final
    state (B=1), rewards (H,), achieved goals (H, ag_dim)), differentiable
    in `actions` and in the state's dynamic fields."""
    xs = rollout_states(make_flat_dynamics(m, state), _extract(state)[0],
                        actions)
    states = _inject(state, xs)
    ags = achieved_goal(m.cfg, m.tree, m.arm, states)
    rs = compute_reward(m.cfg, ags, states.goal)
    final = _inject(state, xs[-1:]).replace(t=state.t + actions.shape[0])
    return final, rs, ags


def refine(m: EnvModel, state: EnvState, actions0: torch.Tensor,
           cfg: GradConfig = GradConfig()):
    """Adam-refine an (H, A) action sequence. Returns (actions, cost_trace)."""
    high = fs.const_on(m.cfg.action_high, state.q.device)

    def loss(actions):
        a = ln.clip(actions, -high, high)
        _, _, ags = rollout(m, state, a)
        return trajectory_cost(m.cfg, ags, state.goal[0], a, cfg.weights)

    a = actions0.detach().to(torch.float32).clone().requires_grad_()
    opt = torch.optim.Adam([a], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    trace = []
    for _ in range(cfg.iters):
        opt.zero_grad()
        with torch.enable_grad():
            c = loss(a)
            c.backward()
        opt.step()
        trace.append(c.detach())
    return torch.clamp(a.detach(), -high, high), torch.stack(trace)

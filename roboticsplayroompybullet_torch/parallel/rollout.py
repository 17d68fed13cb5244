"""Batched env primitives and rollouts (port of the single-device part of
roboticsplayroompybullet_tpu/parallel/rollout.py; the sharded variants come
with the multi-device slice).

The JAX package vmaps its one-env functions over a batch; here the env
functions of envs/core.py are batched already, so these are thin. A
rollout runs the whole horizon in one launch of the `rollout` kernel at
the env step's fidelity on CUDA tensors (the plain lane twin on CPU
tensors), and nothing in it reads the device back.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..envs import core
from ..envs.core import EnvModel
from ..envs.state import EnvState
from . import fused


def batched_reset(m: EnvModel, gen: torch.Generator, batch: int,
                  device="cuda", stats=None
                  ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Reset `batch` envs on `device` from the generator `gen` (on that
    device); see core.reset for `stats`."""
    return core.reset(m, gen, batch, device=device, stats=stats)


def batched_step(m: EnvModel, states: EnvState, actions: torch.Tensor):
    """(states (B,), actions (B, A)) → (states', obs, rewards, info)."""
    return core.step(m, states, actions)


def batched_rollout(m: EnvModel, states: EnvState, actions: torch.Tensor):
    """(B,) states × (B, H, A) actions → (final states, rewards (B, H),
    achieved goals (B, H, ag_dim)): the light path (no obs dict, no
    continuity buffers), as MPC scoring needs."""
    H = actions.shape[1]
    roll = core._fn(m, ("rollout", H),
                    lambda: fused.make_fused_rollout_whole(m, H))
    return roll(states, actions)


def rollout(m: EnvModel, state: EnvState, actions: torch.Tensor):
    """One env (state of B=1) through an (H, A) action sequence → (final
    state, rewards (H,), achieved goals (H, ag_dim))."""
    final, rs, ags = batched_rollout(m, state, actions[None])
    return final, rs[0], ags[0]


def success_rate(rewards: torch.Tensor) -> torch.Tensor:
    """Success fraction of (final-step) rewards."""
    return torch.where(rewards >= 0.0, 1.0, 0.0).mean()

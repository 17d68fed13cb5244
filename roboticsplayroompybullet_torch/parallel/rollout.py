"""Batched and sharded env primitives and rollouts (port of
roboticsplayroompybullet_tpu/parallel/rollout.py).

The JAX package vmaps its one-env functions over a batch; here the env
functions of envs/core.py are batched already, so these are thin. A
rollout runs the whole horizon in one launch of the `rollout` kernel at
the env step's fidelity on CUDA tensors (the plain lane twin on CPU
tensors), and nothing in it reads the device back. The sharded variants
run the same calls on each rank's block of the batch (parallel/mesh.py):
envs are independent, so no collective runs until `success_rate`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..envs import core
from ..envs.core import EnvModel
from ..envs.state import EnvState
from . import fused
from .mesh import check_device, mesh_group, on_mesh


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


def make_sharded_rollout(m: EnvModel, mesh: DeviceMesh):
    """batched_rollout on this rank's shard of the batch (shard_batch):
    (states, actions) → (final states, rewards, ags), each this rank's
    rows of the global result."""
    return on_mesh(mesh, lambda states, actions:
                   batched_rollout(m, states, actions))


def make_sharded_step(m: EnvModel, mesh: DeviceMesh):
    """batched_step on this rank's shard: (states, actions) → (states',
    obs, rewards, info), this rank's rows."""
    return on_mesh(mesh, lambda states, actions:
                   batched_step(m, states, actions))


def success_rate(rewards: torch.Tensor,
                 mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Success fraction of (final-step) rewards; with a mesh, of the
    global batch whose shard `rewards` is (the successes and the envs
    summed over the mesh), as JAX's mean over a sharded array is."""
    ok = torch.where(rewards >= 0.0, 1.0, 0.0)
    if mesh is None:
        return ok.mean()
    check_device(mesh, rewards)
    counts = torch.stack([ok.sum(), ok.new_tensor(float(ok.numel()))])
    dist.all_reduce(counts, group=mesh_group(mesh))
    return counts[0] / counts[1]

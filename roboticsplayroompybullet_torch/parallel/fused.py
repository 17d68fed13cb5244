"""Batched rollouts over the fused control-step kernel (port of
roboticsplayroompybullet_tpu/parallel/fused.py).

The rollout stays in the packed layout X (NF, B) for the whole horizon:
per-step achieved goals are sliced straight out of the packed rows and
EnvState is unpacked once at the end. On CUDA tensors the physics runs in
the hand-written kernel (ops/fused_step.py::make_cuda_*); on CPU tensors
in the plain PyTorch lane twin (make_reference_*). The sharded rollout
runs the same launch on each rank's block of the batch (parallel/mesh.py).
"""
from __future__ import annotations

import torch

from ..envs.core import EnvModel
from ..envs.rewards import compute_reward
from ..envs.state import EnvState
from ..ops import fused_step as fs
from .mesh import on_mesh


def _ag_row_gather(m: EnvModel, with_ee: bool = False):
    """Achieved goals (ag_dim, B) out of the packed state X (NF, B) —
    mirrors obs.achieved_goal for every layout: object/play envs slice
    packed rows; reach envs run lane FK for the ee position
    (environments.py:835 FK branch). with_ee appends the lane-FK ee
    position (3 rows) for MPC reach shaping."""
    return fs.make_lane_ag(m.cfg, m.tree, m.arm, with_ee)


def supports_fused(m: EnvModel) -> bool:
    """Every catalog env rides the fused path (see _ag_row_gather)."""
    return True


def _resolve_backend(backend: str, X: torch.Tensor) -> str:
    """"auto" → the CUDA kernel for a CUDA tensor, the plain lane twin for a
    CPU tensor. "cuda" on a CPU tensor raises in the kernel wrapper; there
    is no fallback."""
    if backend == "auto":
        return "cuda" if X.is_cuda else "reference"
    if backend not in ("cuda", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _dispatch(make_cuda, make_ref, backend: str):
    """Build each backend's function once, pick per call by the tensor."""
    made = {}

    def fn(X, *args):
        b = _resolve_backend(backend, X)
        if b not in made:
            made[b] = make_cuda() if b == "cuda" else make_ref()
        return made[b](X, *args)

    return fn


def _stepper(m: EnvModel, backend: str, ik_iters=None, solve_iters: int = 8,
             n_substeps=None, with_ctrl: bool = False):
    """step_B(X (NF, B), actions (A, B)) → X' (with with_ctrl, (X', C
    (n_arm + 1, B)): the servo targets and gripper command): one `step`
    launch on CUDA tensors."""
    kw = dict(n_substeps=n_substeps, ik_iters=ik_iters,
              solve_iters=solve_iters, with_ctrl=with_ctrl)
    cfg, tree, arm, scene = m
    return _dispatch(lambda: fs.make_cuda_step(cfg, tree, arm, scene, **kw),
                     lambda: fs.make_reference_step(cfg, tree, arm, scene,
                                                    **kw),
                     backend)


def _simmer(m: EnvModel, backend: str, n_substeps=None):
    """sim_B(X (NF, B), ctrl (n_arm, B), grip (B,)) → X': n substeps from
    the given servo targets, one `sim` launch on CUDA tensors."""
    cfg, tree, arm, scene = m
    return _dispatch(
        lambda: fs.make_cuda_sim(cfg, tree, arm, scene, n_substeps),
        lambda: fs.make_reference_sim(cfg, tree, arm, scene, n_substeps),
        backend)


def _roller(m: EnvModel, horizon: int, backend: str, **kw):
    """roll_B(X (NF, B), actions (H, A, B)) → (X', ags (H, ag_dim, B)): one
    `rollout` launch for the whole horizon on CUDA tensors; kw are
    make_cuda_rollout's fidelity options (n_substeps, ik_iters,
    solve_iters, with_ee)."""
    cfg, tree, arm, scene = m
    return _dispatch(
        lambda: fs.make_cuda_rollout(cfg, tree, arm, scene, horizon, **kw),
        lambda: fs.make_reference_rollout(cfg, tree, arm, scene, horizon,
                                          **kw),
        backend)


def make_fused_rollout(m: EnvModel, ik_iters=None, solve_iters: int = 8,
                       backend: str = "auto"):
    """(states (B,), actions (B, H, A)) → (final states, rewards (B, H),
    ags (B, H, ag_dim)), one `step` launch per control step. ik_iters /
    solve_iters below defaults = cheaper preview model (planner use)."""
    stepk = _stepper(m, backend, ik_iters, solve_iters)
    ag_fn = _ag_row_gather(m)

    def rollout(states: EnvState, actions: torch.Tensor):
        X = fs.pack_state(m.cfg, m.tree, states)
        acts = actions.to(torch.float32).permute(1, 2, 0).contiguous()
        ags = []
        for a in acts:                                # (A, B) per step
            X = stepk(X, a)
            ags.append(ag_fn(X))
        ags = torch.stack(ags).permute(2, 0, 1)      # (B, H, ag_dim)
        rs = compute_reward(m.cfg, ags, states.goal[:, None, :])
        final = fs.unpack_state(m.cfg, m.tree, X, states)
        final = final.replace(t=states.t + actions.shape[1])
        return final, rs, ags

    return rollout


def make_fused_batched_step(m: EnvModel, backend: str = "auto"):
    """Single control step through the kernel, EnvState in/out."""
    stepk = _stepper(m, backend)

    def step(states: EnvState, actions: torch.Tensor) -> EnvState:
        X = fs.pack_state(m.cfg, m.tree, states)
        X2 = stepk(X, actions.T.to(torch.float32).contiguous())
        states = fs.unpack_state(m.cfg, m.tree, X2, states)
        return states.replace(t=states.t + 1)

    return step


def make_fused_rollout_whole(m: EnvModel, horizon: int, ik_iters=None,
                             solve_iters: int = 8, backend: str = "auto",
                             n_substeps=None, with_ee: bool = False):
    """Whole-horizon rollout: ONE `rollout` kernel launch for all H control
    steps. (states (B,), actions (B, H, A)) → (final states, rewards
    (B, H), ags (B, H, ag_dim)).

    backend: "cuda" (the hand-written kernel), "reference" (the plain lane
    twin, on whatever device the tensors are), or "auto" (by the tensors'
    device). with_ee appends the ee world position to each per-step ag."""
    roll_B = _roller(m, horizon, backend, n_substeps=n_substeps,
                     ik_iters=ik_iters, solve_iters=solve_iters,
                     with_ee=with_ee)

    def rollout(states: EnvState, actions: torch.Tensor):
        if actions.shape[1] != horizon:
            raise ValueError(f"actions {tuple(actions.shape)} do not have "
                             f"horizon {horizon}")
        X = fs.pack_state(m.cfg, m.tree, states)
        acts = actions.to(torch.float32).permute(1, 2, 0).contiguous()
        Xf, ags = roll_B(X, acts)                    # ags (H, ag_dim, B)
        ags = ags.permute(2, 0, 1)                   # (B, H, ag_dim)
        rs = compute_reward(m.cfg, ags, states.goal[:, None, :])
        final = fs.unpack_state(m.cfg, m.tree, Xf, states)
        final = final.replace(t=states.t + horizon)
        return final, rs, ags

    return rollout


def make_sharded_fused_rollout(m: EnvModel, mesh, horizon: int,
                               ik_iters=None, solve_iters: int = 8,
                               n_substeps=None):
    """make_fused_rollout_whole on this rank's shard of the batch
    (shard_batch): one `rollout` launch a rank, no collective (envs are
    independent). The JAX package's `interpret` and `block_envs` are the
    TPU's; the kernel masks the tail, so any shard width runs."""
    return on_mesh(mesh, make_fused_rollout_whole(
        m, horizon, ik_iters=ik_iters, solve_iters=solve_iters,
        n_substeps=n_substeps))

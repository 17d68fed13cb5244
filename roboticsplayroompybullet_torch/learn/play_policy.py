"""Smooth scripted play-action process for LfP data collection and eval
(port of roboticsplayroompybullet_tpu/learn/play_policy.py).

The reference's play data comes from human VR teleoperation (reference
README.md:2-10): smooth, workspace-bounded end-effector wandering with
occasional grasps. This actor reproduces the STRUCTURE of teleoperated
play:

  * an AR(1) random walk of the commanded EE target INSIDE a workspace
    box derived from the env's goal range, with occasional jumps to a
    fresh uniform target (attention shifts),
  * orientation wandering around the arm's natural downward rest pose,
  * a slow, saturating grip open/close cycle (grasp attempts).

Relative and joint action modes fall back to AR(1) noise on the raw
action box. One process serves both the collector
(tools/collect_play_torch.py) and the eval (tools/eval_lfp_torch.py):
window goals must come from the same distribution the policy was trained
on.

The draws are kept apart from the transform: `_actor_draws` takes a
step's random numbers from a torch.Generator, `_actor_step_from` is the
pure function of the state and those draws, so the tests hold it to the
JAX actor on jax.random's own draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..envs.config import EnvConfig
from ..envs.core import EnvModel, _in_range, _uniform
from ..ops import spatial as sp
from ..ops.fused_step import const_on
from ..solver.eval import rest_orientation
from ..solver.mpc import _normals


class PlayActorConfig(NamedTuple):
    box_lo: Tuple[float, float, float]
    box_hi: Tuple[float, float, float]
    rpy0: Tuple[float, float, float]    # orientation anchor (rest-pose rpy)
    pos_sigma: float = 0.035            # EE-target step scale, m
    pos_smooth: float = 0.85
    rpy_sigma: float = 0.06             # rad per step around rpy0
    rpy_clip: float = 0.5               # max wander from rpy0 (roll/pitch)
    yaw_clip: float = 1.2               # yaw wanders wider
    jump_prob: float = 0.03             # per-step target-resample chance
    grip_smooth: float = 0.97
    grip_sigma: float = 0.25


class PlayActorState(NamedTuple):
    pos: torch.Tensor      # (B, 3) commanded EE target
    vel: torch.Tensor      # (B, A) AR(1) latent (cols 0:3 = target vel in
                           # structured mode; full row in fallback mode)
    rpy: torch.Tensor      # (B, 3) wander offsets from rpy0
    grip: torch.Tensor     # (B,) grip AR(1) latent


class ActorDraws(NamedTuple):
    """One step's random numbers, as the JAX actor draws them from
    split(key, 5)."""
    walk: torch.Tensor     # (B, 3) standard normals (B, A in fallback mode)
    jump: torch.Tensor     # (B, 1) U[0, 1): a jump where below jump_prob
    fresh: torch.Tensor    # (B, 3) U[0, 1): the fresh target in the box
    rpy: torch.Tensor      # (B, 3) standard normals
    grip: torch.Tensor     # (B,) standard normals


def default_actor_config(m: EnvModel) -> PlayActorConfig:
    """Workspace box from the env's goal range (envList.py bounds), padded
    sideways and upward so the actor sweeps past the scene elements;
    orientation anchored at the rest pose's EE rpy (the lane FK in
    float32, solver/eval.py::rest_orientation)."""
    gl = np.asarray(m.cfg.goal_range_low, np.float32)
    gh = np.asarray(m.cfg.goal_range_high, np.float32)
    lo = (float(gl[0] - 0.06), float(gl[1] - 0.04), float(gl[2] - 0.03))
    hi = (float(gh[0] + 0.06), float(gh[1] + 0.06), float(gh[2] + 0.15))
    rpy0 = tuple(float(x) for x in rest_orientation(m))
    return PlayActorConfig(box_lo=lo, box_hi=hi, rpy0=rpy0)


def _structured(env_cfg: EnvConfig) -> bool:
    return env_cfg.action_type in ("absolute_rpy", "absolute_quat")


def _actor_draws(gen: torch.Generator, B: int, A: int) -> ActorDraws:
    """One step's draws for B envs from `gen` (on its device); A is the
    walk's width: 3 in the structured modes, the action width otherwise."""
    dev = gen.device
    return ActorDraws(walk=_normals(gen, (B, A), dev),
                      jump=_uniform(gen, (B, 1), dev),
                      fresh=_uniform(gen, (B, 3), dev),
                      rpy=_normals(gen, (B, 3), dev),
                      grip=_normals(gen, (B,), dev))


def _actor_step_from(env_cfg: EnvConfig, cfg: PlayActorConfig,
                     st: PlayActorState, d: ActorDraws
                     ) -> Tuple[PlayActorState, torch.Tensor]:
    """(state, draws) → (state', actions (B, A)), the JAX actor's step on
    the same draws: the structured EE wander for absolute_rpy /
    absolute_quat, AR(1) on the raw action box otherwise."""
    dev = st.pos.device
    B, A = st.pos.shape[0], env_cfg.action_dim
    high = const_on(env_cfg.action_high, dev)
    if not _structured(env_cfg):
        # legacy fallback: AR(1) on the raw box (collector r4 behavior)
        tail = 0.85 * st.vel + 0.35 * d.walk
        return st._replace(vel=tail), torch.clamp(tail, -high, high)
    lo = const_on(cfg.box_lo, dev)
    hi = const_on(cfg.box_hi, dev)
    # EE-target random walk, clipped into the box
    vel = cfg.pos_smooth * st.vel[:, :3] + d.walk * cfg.pos_sigma
    pos = torch.clamp(st.pos + vel, lo, hi)
    jump = d.jump < cfg.jump_prob
    pos = torch.where(jump, _in_range(d.fresh, cfg.box_lo, cfg.box_hi), pos)
    vel = torch.where(jump, torch.zeros_like(vel), vel)
    vel_full = torch.cat([vel, vel.new_zeros(B, A - 3)], dim=-1)
    # orientation wander around the rest rpy
    rpy = 0.95 * st.rpy + d.rpy * cfg.rpy_sigma
    clip = const_on((cfg.rpy_clip, cfg.rpy_clip, cfg.yaw_clip), dev)
    rpy = torch.clamp(rpy, -clip, clip)
    # slow saturating grasp cycle
    grip = cfg.grip_smooth * st.grip + d.grip * cfg.grip_sigma
    grip = torch.clamp(grip, -1.5, 1.5)
    g_cmd = torch.tanh(2.0 * grip)[:, None]

    ang = const_on(cfg.rpy0, dev) + rpy
    if env_cfg.action_type == "absolute_rpy":
        acts = torch.cat([pos, ang, g_cmd], dim=-1)
    elif env_cfg.use_orientation:                # absolute_quat
        acts = torch.cat([pos, sp.quat_from_euler(ang), g_cmd], dim=-1)
    else:
        acts = torch.cat([pos, g_cmd], dim=-1)
    acts = torch.clamp(acts, -high, high)
    return st._replace(pos=pos, vel=vel_full, rpy=rpy, grip=grip), acts


def make_play_actor(m: EnvModel, cfg: Optional[PlayActorConfig] = None):
    """Returns (init(gen, B) -> state, step(state, gen) -> (state,
    actions (B, A))), on the device of the torch.Generator `gen`.

    Actions are assembled for the env's action mode; absolute pose modes
    (absolute_rpy / absolute_quat) get the structured EE wander, all other
    modes fall back to AR(1) noise on the raw action box (relative modes
    already mean small motions at zero)."""
    if cfg is None:
        cfg = default_actor_config(m)
    A = m.cfg.action_dim
    walk = 3 if _structured(m.cfg) else A

    def init(gen: torch.Generator, B: int) -> PlayActorState:
        dev = gen.device
        pos = _in_range(_uniform(gen, (B, 3), dev), cfg.box_lo, cfg.box_hi)
        grip = _in_range(_uniform(gen, (B,), dev), -1.0, 1.0)
        return PlayActorState(
            pos=pos, vel=torch.zeros(B, A, device=dev),
            rpy=torch.zeros(B, 3, device=dev), grip=grip)

    def step(st: PlayActorState, gen: torch.Generator):
        return _actor_step_from(m.cfg, cfg, st,
                                _actor_draws(gen, st.pos.shape[0], walk))

    return init, step

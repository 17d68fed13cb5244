"""Env core: batched reset / step and the action-mode control (port of
roboticsplayroompybullet_tpu/envs/core.py).

The reference's `playEnv.step` pipeline (environments.py:206-214): clip
action → perform_action (mode dispatch → IK → rate-limited joint targets +
gripper motors) → 12 physics substeps → calc_state → reward. Every function
here takes an EnvState with the batch leading, as the JAX package's vmapped
versions do.

The physics is the port's one: the lane twin of ops/fused_step.py and its
kernel. On CUDA tensors a control step is one launch of the `step` kernel
(control, i.e. action decode and DLS IK, included: the kernel also hands
back the servo targets it chose), and reset's 100-substep settle one launch
of the `sim` kernel; on CPU tensors the plain PyTorch twin runs the same
functions (parallel/fused.py::_dispatch). There is no fallback between the
two.

Randomness comes from a torch.Generator on the state's device, through
`_uniform` and `_randint`, which the tests replace with the draws
jax.random made. Reset's two loops (the out-of-bounds re-place and the
reset-until-unsolved) redraw and re-settle only the envs that still need
it; each reads one count back from the device per attempt, and the attempts
taken can be returned through `stats`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import playroom
from ..models.arms import get_arm, ArmConfig
from ..models.kinetree import KineTree
from ..models.playroom import Scene
from ..ops import fused_step as fs
from ..ops import spatial as sp
from .config import EnvConfig
from .obs import calc_obs
from .rewards import compute_reward
from .state import EnvState

SETTLE_SUBSTEPS = 100       # environments.py:534-535
MAX_PLACE_ATTEMPTS = 20     # the re-place loop's cap (JAX core.py:249)
MAX_RESET_REDRAWS = 100     # the reset-until-unsolved loop's cap (:323)


class _Model(NamedTuple):
    cfg: EnvConfig
    tree: KineTree
    arm: ArmConfig
    scene: Scene


class EnvModel(_Model):
    """Static bundle of host numpy constants the physics closes over. Its
    kernel dispatchers (`_fn`) live in the instance's own dict, so they go
    with it."""


def build_model(cfg: EnvConfig) -> EnvModel:
    tree, arm = get_arm(cfg.arm)
    kind = cfg.scene_kind
    if kind == "complex":
        scene = playroom.complex_scene(cfg.num_objects)
    elif kind == "push":
        scene = playroom.push_scene(cfg.num_objects)
    else:
        scene = playroom.default_scene(cfg.num_objects)
    return EnvModel(cfg, tree, arm, scene)


def _fn(m: EnvModel, key, make):
    """make() once per model and key: the kernel dispatchers (the model's
    constants go to the card once, not per call), kept on the model."""
    fns = vars(m).setdefault("_fns", {})
    if key not in fns:
        fns[key] = make()
    return fns[key]


def _stepper(m: EnvModel):
    from ..parallel import fused
    return _fn(m, "step", lambda: fused._stepper(m, "auto", with_ctrl=True))


def _settler(m: EnvModel):
    from ..parallel import fused
    return _fn(m, "settle", lambda: fused._simmer(
        m, "auto", n_substeps=SETTLE_SUBSTEPS))


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) float32 draws of `shape` from `gen`."""
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def _randint(gen: torch.Generator, high: int, shape, device) -> torch.Tensor:
    """Integers in [0, high) of `shape` from `gen`."""
    return torch.randint(high, shape, generator=gen, device=device)


def _in_range(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """U[0, 1) draws scaled to [lo, hi), as jax.random.uniform scales."""
    lo = fs.const_on(lo, u.device)
    hi = fs.const_on(hi, u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _rest(m: EnvModel, device) -> torch.Tensor:
    """The arm's rest pose as an (n_dof,) q, gripper dofs 0."""
    rest = np.zeros(m.tree.n_dof, np.float32)
    rest[:m.arm.n_arm] = np.asarray(m.arm.rest_pose, np.float32)
    return fs.const_on(rest, device)


# ---------------------------------------------------------------------------
# control: action → servo targets (perform_action, environments.py:915-1034)
# ---------------------------------------------------------------------------

def control(m: EnvModel, state: EnvState, action: torch.Tensor):
    """(B, A) actions → (servo targets (B, n_arm), grip (B,)) by the plain
    lane control (make_lane_control: the action decode, DLS IK at the arm's
    iterations, goto_joint_poses' clamps, in float64). The targets are also
    the step's info["target_poses"]. The env step on the card runs the same
    control inside the `step` kernel."""
    ctrl = fs.make_lane_control(m.cfg, m.tree, m.arm)
    targets, grip = ctrl(state.q.T, action.T.to(torch.float32))
    return targets.T, grip


# ---------------------------------------------------------------------------
# reset (environments.py:173-187, 492-603)
# ---------------------------------------------------------------------------

def _default_state(m: EnvModel, B: int, device) -> EnvState:
    """B envs at the rest pose, objects at the origin with the identity
    quaternion, no goal, no previous observation, t = 0."""
    cfg = m.cfg
    n_obj = max(cfg.num_objects, 1)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa
    q = _rest(m, device).expand(B, -1).clone()
    return EnvState(
        q=q, qd=z(B, m.tree.n_dof), ctrl_q=q[:, :m.arm.n_arm].clone(),
        grip=z(B), obj_pos=z(B, n_obj, 3),
        obj_quat=fs.const_on(np.array([0.0, 0.0, 0.0, 1.0]), device).expand(
            B, n_obj, 4).clone(),
        obj_vel=z(B, n_obj, 3), obj_angvel=z(B, n_obj, 3),
        art_q=z(B, 4), art_qd=z(B, 4), goal=z(B, cfg.goal_dim),
        prev_obs=z(B, cfg.obs_dim), prev_ag=z(B, cfg.ag_dim),
        has_prev=torch.zeros(B, dtype=torch.bool, device=device),
        rng=torch.zeros((B, 2), dtype=torch.int64, device=device),
        t=torch.zeros(B, dtype=torch.int32, device=device))


def _reset_arm(m: EnvModel, state: EnvState, gen: torch.Generator,
               o: Optional[torch.Tensor]) -> EnvState:
    """reset_arm (environments.py:575-596): IK from the rest pose (24
    iterations for both arms) to a random ee position in the goal range
    (UR5: 0.2 higher), or to o's pose; then write q[:6].

    The reference takes only the first SIX IK outputs regardless of arm
    (environments.py:593), so the Panda's joint 7 stays at its rest
    value."""
    cfg, arm = m.cfg, m.arm
    B, dev = state.q.shape[0], state.q.device
    rest = _rest(m, dev).expand(B, -1)
    ident = fs.const_on(np.array([0.0, 0.0, 0.0, 1.0]), dev).expand(B, 4)
    if o is None:
        pos = _in_range(_uniform(gen, (B, 3), dev), cfg.goal_range_low,
                        cfg.goal_range_high)
        if arm.name == "UR5":
            pos = pos + fs.const_on(np.array([0.0, 0.0, 0.2]), dev)  # :580
        quat = ident
    else:
        pos = o[:, 0:3]
        if cfg.use_orientation:
            quat = sp.quat_normalize(o[:, 6:10] if cfg.return_velocity
                                     else o[:, 3:7])
        else:
            quat = ident
    sol = fs.lane_ik_dls(m.tree, arm, rest.T, pos.T.contiguous(),
                         quat.T.contiguous(), iters=24).T
    q = torch.cat([sol[:, :6], rest[:, 6:]], dim=-1)
    return state.replace(q=q, qd=torch.zeros_like(state.qd),
                         ctrl_q=q[:, :arm.n_arm])


def _objects_oob(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """(B,): any real object coordinate past env_upper_bound
    (environments.py:536-538: the reference checks only the UPPER
    bound)."""
    hi = fs.const_on(cfg.env_range_high, state.obj_pos.device)
    return (state.obj_pos[:, :cfg.num_objects] > hi).flatten(1).any(-1)


def _place_and_settle(m: EnvModel, state: EnvState,
                      gen: torch.Generator) -> EnvState:
    """One random placement of every object (staggered heights, the fixed
    quaternion, at rest) and the 100-substep settle
    (environments.py:528-535), with the servo targets and gripper command
    of `state` (the rest pose and 0 at reset): one `sim` launch on the
    card."""
    cfg = m.cfg
    B, dev = state.q.shape[0], state.q.device
    no = cfg.num_objects
    pos = _in_range(_uniform(gen, (B, no, 3), dev), cfg.obj_lower_bound,
                    cfg.obj_upper_bound)
    stagger = np.zeros((no, 3), np.float32)
    stagger[:, 2] = 0.03 * (np.arange(no) + 1)
    pos = pos + fs.const_on(stagger, dev)
    quat = fs.const_on(np.array([0.0, 0.0, 0.7071, 0.7071]), dev).expand(
        B, no, 4)
    state = state.replace(obj_pos=pos, obj_quat=quat,
                          obj_vel=torch.zeros_like(state.obj_vel),
                          obj_angvel=torch.zeros_like(state.obj_angvel))
    X = fs.pack_state(cfg, m.tree, state)
    X2 = _settler(m)(X, state.ctrl_q.T.contiguous(),
                     state.grip.contiguous())
    return fs.unpack_state(cfg, m.tree, X2, state)


def _take(state: EnvState, idx: torch.Tensor) -> EnvState:
    return EnvState(**{f: getattr(state, f)[idx]
                       for f in state.__dataclass_fields__})


def _put(state: EnvState, idx: torch.Tensor, sub: EnvState) -> EnvState:
    """state with the envs idx replaced by sub's."""
    out = {}
    for f in state.__dataclass_fields__:
        v = getattr(state, f).clone()
        v[idx] = getattr(sub, f)
        out[f] = v
    return EnvState(**out)


def _reset_objects(m: EnvModel, state: EnvState, gen: torch.Generator,
                   o: Optional[torch.Tensor],
                   count: Optional[torch.Tensor] = None) -> EnvState:
    """reset_object_pos (environments.py:519-556): articulated objects to
    their defaults, then either a random placement and settle with the
    out-of-bounds RE-PLACE loop (environments.py:536-539) or o's object
    poses.

    The reference re-places every object of an env while any coordinate
    settled past env_upper_bound, unboundedly; as in the JAX package the
    loop stops at MAX_PLACE_ATTEMPTS placements, keeping the last draw.
    Here the loop redraws and re-settles only the envs still out of
    bounds; `count` (B,) int, when given, adds each env's placements."""
    cfg = m.cfg
    state = state.replace(art_q=torch.zeros_like(state.art_q),
                          art_qd=torch.zeros_like(state.art_qd))
    if cfg.num_objects == 0:
        return state
    if o is None:
        state = _place_and_settle(m, state, gen)
        if count is not None:
            count += 1
        for _ in range(1, MAX_PLACE_ATTEMPTS):
            idx = _objects_oob(cfg, state).nonzero()[:, 0]
            if idx.numel() == 0:            # one read of the device
                break
            state = _put(state, idx,
                         _place_and_settle(m, _take(state, idx), gen))
            if count is not None:
                count[idx] += 1
        return state
    # state injection: the reference's layout quirk (environments.py:
    # 542-556): index 11 / stride 10 with orientation, else 7 / 6
    index, inc = (11, 10) if cfg.use_orientation else (7, 6)
    obj_pos = state.obj_pos.clone()
    obj_quat = state.obj_quat.clone()
    for i in range(cfg.num_objects):
        obj_pos[:, i] = o[:, index:index + 3]
        if cfg.use_orientation:
            obj_quat[:, i] = sp.quat_normalize(o[:, index + 3:index + 7])
        index += inc
    return state.replace(obj_pos=obj_pos, obj_quat=obj_quat,
                         obj_vel=torch.zeros_like(state.obj_vel),
                         obj_angvel=torch.zeros_like(state.obj_angvel))


def reset_goal(m: EnvModel, state: EnvState, gen: torch.Generator,
               goal: Optional[torch.Tensor] = None) -> EnvState:
    """reset_goal_pos (environments.py:492-516): the given goal, or for
    play envs the current achieved goal with one random dim moved by
    U(0, 1), else a uniform draw in the goal range per goal."""
    cfg = m.cfg
    B, dev = state.q.shape[0], state.q.device
    if goal is not None:
        goal = torch.as_tensor(goal, dtype=torch.float32, device=dev)
        return state.replace(goal=goal.expand(B, cfg.goal_dim).clone())
    if cfg.play:
        ag = calc_obs(cfg, m.tree, m.arm, m.scene, state)["achieved_goal"]
        idx = _randint(gen, cfg.goal_dim, (B,), dev)
        delta = _uniform(gen, (B,), dev)
        hot = torch.nn.functional.one_hot(idx, cfg.goal_dim).to(ag.dtype)
        return state.replace(goal=ag + hot * delta[:, None])
    g = _in_range(_uniform(gen, (B, cfg.num_goals, 3), dev),
                  cfg.goal_range_low, cfg.goal_range_high)
    return state.replace(goal=g.reshape(B, 3 * cfg.num_goals))


def _attempt(m: EnvModel, B: int, gen: torch.Generator,
             o: Optional[torch.Tensor], device, count=None):
    """One reset draw of B envs → (state, reward (B,))."""
    state = _default_state(m, B, device)
    state = _reset_objects(m, state, gen, o, count)
    state = _reset_arm(m, state, gen, o)
    state = reset_goal(m, state, gen)
    obs = calc_obs(m.cfg, m.tree, m.arm, m.scene, state)
    return state, compute_reward(m.cfg, obs["achieved_goal"],
                                 obs["desired_goal"])


def reset(m: EnvModel, gen: torch.Generator, batch: int = 1,
          o: Optional[torch.Tensor] = None, device="cuda",
          stats: Optional[dict] = None
          ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Reset `batch` envs on `device` (the card unless the caller asks for
    the CPU), with the resample-until-unsolved loop (environments.py:
    179-186). `gen` is a torch.Generator on that device.

    With `o` ((A_o,) or (batch, A_o), the reference's state-injection
    vector) there is no loop and no settle. Without it, envs whose draw
    is already solved (reward > −1) are drawn again, only they, up to
    MAX_RESET_REDRAWS times as the JAX package bounds the reference's
    unbounded loop, keeping the last draw. `stats`, when given, receives
    per env (batch,) int tensors: "resets", the draws taken, and
    "placements", the object placements (settles) taken over all of
    them."""
    if o is not None:
        o = torch.as_tensor(o, dtype=torch.float32, device=device)
        o = o.expand(batch, o.shape[-1])
        state, _ = _attempt(m, batch, gen, o, device)
        draws = torch.ones(batch, dtype=torch.int64, device=device)
        placed = torch.zeros_like(draws)
    else:
        placed = torch.zeros(batch, dtype=torch.int64, device=device)
        state, r = _attempt(m, batch, gen, None, device, placed)
        draws = torch.ones_like(placed)
        for _ in range(MAX_RESET_REDRAWS):
            idx = (r > -1.0).nonzero()[:, 0]
            if idx.numel() == 0:            # one read of the device
                break
            sub_placed = torch.zeros(idx.shape[0], dtype=torch.int64,
                                     device=device)
            sub, r_sub = _attempt(m, idx.shape[0], gen, None, device,
                                  sub_placed)
            state = _put(state, idx, sub)
            r = r.clone()
            r[idx] = r_sub
            draws[idx] += 1
            placed[idx] += sub_placed
    if stats is not None:
        stats.update(resets=draws, placements=placed)
    obs = calc_obs(m.cfg, m.tree, m.arm, m.scene, state)
    state = state.replace(prev_obs=obs.pop("_prev_obs"),
                          prev_ag=obs.pop("_prev_ag"),
                          has_prev=torch.ones_like(state.has_prev))
    return state, obs


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

def _physics(m: EnvModel, state: EnvState, action: torch.Tensor):
    """clip → control → 12 substeps: one `step` launch on the card.
    Returns (state with the new physics, servo targets and gripper
    command; the targets (B, n_arm))."""
    X = fs.pack_state(m.cfg, m.tree, state)
    X2, C = _stepper(m)(X, action.to(torch.float32).T.contiguous())
    n_arm = m.arm.n_arm
    targets = C[:n_arm].T
    state = fs.unpack_state(m.cfg, m.tree, X2, state)
    return state.replace(ctrl_q=targets, grip=C[n_arm]), targets


def step_physics_only(m: EnvModel, state: EnvState,
                      action: torch.Tensor) -> EnvState:
    """Light control step: clip → control → 12 substeps, t + 1. Skips the
    observation and the continuity buffers (the MPC loop's executed
    step)."""
    state, _ = _physics(m, state, action)
    return state.replace(t=state.t + 1)


def step(m: EnvModel, state: EnvState, action: torch.Tensor):
    """One 25 Hz control step of B envs, actions (B, A). Returns (state',
    obs, reward (B,), info) with info's "is_success" (B,) and
    "target_poses" (B, n_arm)."""
    cfg = m.cfg
    state, targets = _physics(m, state, action)
    obs = calc_obs(cfg, m.tree, m.arm, m.scene, state)
    state = state.replace(prev_obs=obs.pop("_prev_obs"),
                          prev_ag=obs.pop("_prev_ag"),
                          has_prev=torch.ones_like(state.has_prev),
                          t=state.t + 1)
    r = compute_reward(cfg, obs["achieved_goal"], obs["desired_goal"])
    info = {"is_success": torch.where(r < 0, 0.0, 1.0),
            "target_poses": targets}
    return state, obs, r, info

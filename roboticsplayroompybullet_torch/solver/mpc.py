"""Sampling MPC (MPPI / CEM) over the fused rollout kernel (port of the
single-device paths of roboticsplayroompybullet_tpu/solver/mpc.py).

A receding-horizon controller that scores a population of action
sequences per replan: the population is the kernel batch, so each
refinement iteration is one whole-horizon `rollout` launch, and the
executed control step one `step` launch (ops/fused_step.py). Two planners:
the fused one (`make_fused_planner`, the batched MPC step, their closed
loop) previews with the cheap model (8 IK / 8 solve iterations), and the
single-device `plan` / `mpc_rollout` scores at the env step's fidelity
(the arm's IK iterations, 8 solve iterations). The MPPI/CEM
statistics are plain torch ops over the population axis, batched over any
leading env axes (the JAX package's vmap written out).

Device: CUDA tensors run the hand-written kernels, CPU tensors the plain
PyTorch lane twin (parallel/fused.py::_dispatch); backend="cuda" on CPU
tensors raises. Randomness comes from a torch.Generator on the tensors'
device; the Gaussian draw (`_normals`) is kept apart from the AR(1)/clip
transform (`_sample_from`) so that tests can feed the transform the normals
jax.random draws. Nothing inside a replan reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..envs import core
from ..envs.core import EnvModel
from ..envs.obs import achieved_goal, ee_state
from ..envs.rewards import compute_reward
from ..envs.state import EnvState
from ..ops import fused_step as fs
from ..ops import spatial as sp
from ..parallel import fused as _fused
from .cost import CostWeights, trajectory_cost


class MPCConfig(NamedTuple):
    horizon: int = 40
    pop: int = 512              # population per replan iteration (per env)
    iters: int = 3              # CEM/MPPI refinement iterations per replan
    elite_frac: float = 0.1     # CEM
    temperature: float = 0.05   # MPPI
    sigma_init: float = 0.25
    sigma_min: float = 0.02
    smooth: float = 0.7         # AR(1) coefficient for time-correlated noise
    algorithm: str = "mppi"     # "mppi" | "cem"
    weights: CostWeights = CostWeights()
    # preview-model fidelity of the planners' rollouts (None = the arm's
    # default IK iterations)
    preview_ik_iters: Optional[int] = 8
    preview_solve_iters: int = 8


class PlanState(NamedTuple):
    mean: torch.Tensor          # (..., H, A) current nominal action sequence
    sigma: torch.Tensor         # (..., H, A) current stddev


def init_plan(m: EnvModel, cfg: MPCConfig, device="cuda") -> PlanState:
    """Zero mean, sigma_init everywhere, on the card unless `device` says
    otherwise."""
    A = m.cfg.action_dim
    return PlanState(
        mean=torch.zeros((cfg.horizon, A), dtype=torch.float32,
                         device=device),
        sigma=torch.full((cfg.horizon, A), cfg.sigma_init,
                         dtype=torch.float32, device=device))


def init_plan_from_state(m: EnvModel, cfg: MPCConfig,
                         states: EnvState) -> PlanState:
    """One plan per env of `states` (B,), (B, H, A), whose nominal sequence
    HOLDS the current pose.

    For absolute action modes a zero mean commands the EE to the world
    origin (environments.py:938-947) — a violent initial jerk that wrecks
    the search. Seed the mean with the current EE pose / joint
    configuration instead, so candidate 0 is a no-op. Relative modes
    already mean "stay" at zero."""
    B = states.q.shape[0]
    pl = init_plan(m, cfg, device=states.q.device)
    sigma = pl.sigma.expand(B, -1, -1).clone()
    at = m.cfg.action_type
    if not at.startswith("absolute"):
        return PlanState(pl.mean.expand(B, -1, -1).clone(), sigma)
    zero = torch.zeros((B, 1), dtype=torch.float32, device=states.q.device)
    if at == "absolute_joints":
        hold = torch.cat([states.q[:, :m.arm.n_arm], zero], dim=-1)
    else:
        pos, quat, _, _ = ee_state(m.tree, m.arm, states.q, states.qd)
        if at == "absolute_quat":
            orn = [quat] if m.cfg.use_orientation else []
        else:                                     # absolute_rpy
            orn = [sp.quat_to_euler(quat)]
        hold = torch.cat([pos] + orn + [zero], dim=-1)
    mean = hold[:, None, :].expand(B, cfg.horizon, hold.shape[-1])
    return PlanState(mean.to(torch.float32).contiguous(), sigma)


def init_batched_plan(m: EnvModel, cfg: MPCConfig, n_envs: int,
                      states: Optional[EnvState] = None,
                      device="cuda") -> PlanState:
    """PlanState with a leading env axis — one independent plan per env.
    With `states`, each plan is seeded to hold that env's current pose
    (init_plan_from_state, on the states' device)."""
    if states is not None:
        return init_plan_from_state(m, cfg, states)
    pl = init_plan(m, cfg, device=device)
    return PlanState(*(x.expand(n_envs, -1, -1).clone() for x in pl))


def shift_plan(plan: PlanState, cfg: MPCConfig) -> PlanState:
    """Receding-horizon warm start: drop step 0, repeat the tail."""
    mean = torch.cat([plan.mean[..., 1:, :], plan.mean[..., -1:, :]], dim=-2)
    return PlanState(mean, torch.clamp_min(plan.sigma, cfg.sigma_min))


def _normals(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normals of `shape` from `gen` (on `device`)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _sample_from(plan: PlanState, cfg: MPCConfig, noise: torch.Tensor,
                 high: torch.Tensor) -> torch.Tensor:
    """The AR(1)/clip transform of standard normals noise (..., n, H, A)
    into n time-correlated action sequences about plan (..., H, A),
    clipped to ±high; candidate 0 carries the unperturbed mean (the
    standard MPPI warm start)."""
    root = float(np.sqrt(np.float32(1.0 - cfg.smooth ** 2)))
    prev = torch.zeros_like(noise[..., 0, :])
    corr = []
    for h in range(noise.shape[-2]):
        prev = cfg.smooth * prev + root * noise[..., h, :]
        corr.append(prev)
    corr = torch.stack(corr, dim=-2)                      # (..., n, H, A)
    acts = plan.mean[..., None, :, :] + plan.sigma[..., None, :, :] * corr
    acts = torch.cat([plan.mean[..., None, :, :], acts[..., 1:, :, :]],
                     dim=-3)
    return torch.clamp(acts, -high, high)


def _sample(gen: torch.Generator, plan: PlanState, cfg: MPCConfig, n: int,
            high: torch.Tensor) -> torch.Tensor:
    """n time-correlated Gaussian action sequences per plan, clipped."""
    shape = plan.mean.shape[:-2] + (n,) + plan.mean.shape[-2:]
    return _sample_from(plan, cfg, _normals(gen, shape, plan.mean.device),
                        high)


def _weighted(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_n w[..., n] x[..., n, H, A] → (..., H, A)."""
    return (w[..., None, None] * x).sum(-3)


def _mppi_update(plan: PlanState, cfg: MPCConfig, actions: torch.Tensor,
                 costs: torch.Tensor) -> PlanState:
    """Softmax-weighted mean over all samples; actions (..., n, H, A),
    costs (..., n)."""
    best = costs.amin(-1, keepdim=True)
    w = torch.exp(-(costs - best) / cfg.temperature)
    wsum = w.sum(-1)
    mean = _weighted(w, actions) / torch.clamp_min(wsum, 1e-9)[..., None,
                                                               None]
    return PlanState(mean=mean, sigma=plan.sigma)


def _cem_update(plan: PlanState, cfg: MPCConfig, actions: torch.Tensor,
                costs: torch.Tensor) -> PlanState:
    """Moments of the elite: every sample whose cost is at most the k-th
    smallest (ties all enter), k = pop · elite_frac."""
    k = max(1, int(cfg.pop * cfg.elite_frac))
    thresh = torch.kthvalue(costs, k, dim=-1, keepdim=True).values
    w = (costs <= thresh).to(torch.float32)
    wsum = torch.clamp_min(w.sum(-1), 1.0)[..., None, None]
    mean = _weighted(w, actions) / wsum
    var = torch.clamp_min(_weighted(w, torch.square(actions)) / wsum
                          - torch.square(mean), 0.0)
    sigma = torch.clamp_min(torch.sqrt(var), cfg.sigma_min)
    return PlanState(mean=mean, sigma=sigma)


def _update_fn(cfg: MPCConfig):
    if cfg.algorithm not in ("mppi", "cem"):
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    return _mppi_update if cfg.algorithm == "mppi" else _cem_update


def _score(m: EnvModel, cfg: MPCConfig, state: EnvState,
           actions: torch.Tensor) -> torch.Tensor:
    """(n, H, A) candidates → (n,) costs, all from the one env of `state`:
    one full-fidelity `rollout` launch of the n tiled start states on the
    card."""
    roll = core._fn(m, ("score", cfg.horizon), lambda: _fused._roller(
        m, cfg.horizon, "auto"))
    X = fs.pack_state(m.cfg, m.tree, state).repeat(1, actions.shape[0])
    _, ags = roll(X, actions.permute(1, 2, 0).contiguous())
    return trajectory_cost(m.cfg, ags.permute(2, 0, 1), state.goal, actions,
                           cfg.weights)


def _plan_iters(m: EnvModel, cfg: MPCConfig, state: EnvState,
                plan_state: PlanState, gen: torch.Generator):
    """cfg.iters refinements of plan_state (H, A) on cfg.pop candidates →
    (plan, best cost of the last iteration)."""
    hi = _bounds(m, state.q)
    update = _update_fn(cfg)
    pl, best = plan_state, None
    for _ in range(cfg.iters):
        acts = _sample(gen, pl, cfg, cfg.pop, hi)
        costs = _score(m, cfg, state, acts)
        pl = update(pl, cfg, acts, costs)
        best = costs.amin()
    return pl, best


def plan(m: EnvModel, cfg: MPCConfig, state: EnvState,
         plan_state: PlanState, gen: torch.Generator):
    """Single-device replan of the one env of `state` from plan_state,
    scored at the env step's fidelity. Returns (new plan, best rollout
    cost)."""
    if state.q.shape[0] != 1:
        raise ValueError(f"plan takes one env, got {state.q.shape[0]}")
    return _plan_iters(m, cfg, state, plan_state, gen)


def mpc_rollout(m: EnvModel, cfg: MPCConfig, state: EnvState,
                gen: torch.Generator, n_steps: int, planner=None):
    """Receding-horizon loop of one env from init_plan's zero mean: replan
    → apply the first action (core.step_physics_only, one `step` launch)
    → shift. Returns (final state, actions (T, A), rewards (T,), best
    costs (T,)). `planner(state, plan, gen)` defaults to `plan`."""
    do_plan = planner if planner is not None else (
        lambda st, pl, g: plan(m, cfg, st, pl, g))
    pl = init_plan(m, cfg, device=state.q.device)
    acts, rs, bests = [], [], []
    for _ in range(n_steps):
        pl, best = do_plan(state, pl, gen)
        a = pl.mean[0]
        state = core.step_physics_only(m, state, a[None])
        ag = achieved_goal(m.cfg, m.tree, m.arm, state)
        rs.append(compute_reward(m.cfg, ag, state.goal)[0])
        acts.append(a)
        bests.append(best)
        pl = shift_plan(pl, cfg)
    return state, torch.stack(acts), torch.stack(rs), torch.stack(bests)


def _preview(m: EnvModel, cfg: MPCConfig, backend: str,
             n_substeps=None, with_ee: bool = False):
    """roll_B(X (NF, B), actions (H, A, B)) → (X', ags (H, ag_dim, B)) at the
    preview model's fidelity: one `rollout` launch on CUDA tensors."""
    return _fused._roller(m, cfg.horizon, backend, n_substeps=n_substeps,
                          ik_iters=cfg.preview_ik_iters,
                          solve_iters=cfg.preview_solve_iters, with_ee=with_ee)


def _bounds(m: EnvModel, like: torch.Tensor) -> torch.Tensor:
    """action_high (A,) on like's device, copied there once (fs._const's
    cache): a copy per call would wait for the card."""
    return fs._const(np.asarray(m.cfg.action_high, np.float32), like[0, 0])


def make_fused_planner(m: EnvModel, cfg: MPCConfig, backend: str = "auto"):
    """Single-env replanner scoring its candidates through the fused
    rollout. The population is the kernel batch (any size: the kernel
    masks the tail). Returns plan_fn(state, plan_state, gen) → (plan,
    best cost of the last iteration), with state an EnvState of one env,
    plan_state (H, A) and gen a torch.Generator on the state's device."""
    roll = _preview(m, cfg, backend)
    update = _update_fn(cfg)

    def plan_fn(state: EnvState, plan_state: PlanState,
                gen: torch.Generator):
        if state.q.shape[0] != 1:
            raise ValueError(f"plan_fn takes one env, got {state.q.shape[0]}")
        X = fs.pack_state(m.cfg, m.tree, state).repeat(1, cfg.pop)
        hi = _bounds(m, X)
        pl, best = plan_state, None
        for _ in range(cfg.iters):
            acts = _sample(gen, pl, cfg, cfg.pop, hi)       # (pop, H, A)
            _, ags = roll(X, acts.permute(1, 2, 0).contiguous())
            costs = trajectory_cost(m.cfg, ags.permute(2, 0, 1), state.goal,
                                    acts, cfg.weights)      # (pop,)
            pl = update(pl, cfg, acts, costs)
            best = costs.amin()
        return pl, best

    return plan_fn


def make_batched_fused_mpc_step(m: EnvModel, cfg: MPCConfig, n_envs: int,
                                backend: str = "auto",
                                n_substeps: Optional[int] = None,
                                exec_ik_iters: Optional[int] = None,
                                exec_solve_iters: int = 8,
                                cost_fn=None, with_ee: bool = False):
    """One receding-horizon control step for a BATCH of independently
    goal-conditioned envs — the task-competence eval path.

    Each of the n_envs envs refines its own cfg.pop-candidate plan against
    its own goal: all n_envs × pop preview rollouts ride ONE `rollout`
    launch per iteration (env-major: candidate p of env e is column
    e·pop + p), then every env advances one PARITY-model control step (one
    `step` launch at B = n_envs; the planner previews with the cheap model
    but is scored against the reference-fidelity physics).

    cost_fn(ags (n_envs, pop, H, agE), goals (n_envs, 1, goal_dim), acts
    (n_envs, pop, H, A), params) → (n_envs, pop) overrides trajectory_cost;
    params is the cost_params mapping passed to step_fn, its tensors with
    the env axis leading. with_ee appends the ee position to the preview
    ags the cost sees. Returns step_fn(states, plans, gen, cost_params=None)
    → (states', plans', rewards (n_envs,), ags (n_envs, ag_dim))."""
    pop, H = cfg.pop, cfg.horizon
    B = n_envs * pop
    roll = _preview(m, cfg, backend, n_substeps=n_substeps, with_ee=with_ee)
    stepk = _fused._stepper(m, backend, ik_iters=exec_ik_iters,
                            solve_iters=exec_solve_iters,
                            n_substeps=n_substeps)
    if cost_fn is None:
        def cost_fn(ags, goals, acts, params):
            return trajectory_cost(m.cfg, ags, goals, acts, cfg.weights)
    update = _update_fn(cfg)

    def step_fn(states: EnvState, plans: PlanState, gen: torch.Generator,
                cost_params=None):
        cp = {} if cost_params is None else cost_params
        X = fs.pack_state(m.cfg, m.tree, states)             # (NF, n_envs)
        Xrep = X.repeat_interleave(pop, dim=1)               # (NF, B)
        hi = _bounds(m, X)
        goals = states.goal[:, None, :]
        for _ in range(cfg.iters):
            acts = _sample(gen, plans, cfg, pop, hi)  # (n_envs, pop, H, A)
            _, ags = roll(Xrep, acts.reshape(B, H, -1).permute(1, 2, 0)
                          .contiguous())                     # (H, agE, B)
            ags = ags.permute(2, 0, 1).reshape(n_envs, pop, H, -1)
            plans = update(plans, cfg, acts, cost_fn(ags, goals, acts, cp))
        a = plans.mean[:, 0]                                 # (n_envs, A)
        X2 = stepk(X, a.T.contiguous())
        states2 = fs.unpack_state(m.cfg, m.tree, X2, states)
        states2 = states2.replace(t=states.t + 1)
        ags = achieved_goal(m.cfg, m.tree, m.arm, states2)
        rs = compute_reward(m.cfg, ags, states2.goal)
        return states2, shift_plan(plans, cfg), rs, ags

    return step_fn


def make_fused_mpc_rollout(m: EnvModel, cfg: MPCConfig, n_steps: int,
                           backend: str = "auto"):
    """Receding-horizon loop of one env from init_plan's zero mean: the
    fused planner, then one parity-model control step (a `step` launch at
    B=1). Returns run(state, gen) → (final state, actions (T, A), rewards
    (T,), best costs (T,)), state an EnvState of one env."""
    planner = make_fused_planner(m, cfg, backend=backend)
    step = _fused.make_fused_batched_step(m, backend=backend)

    def run(state: EnvState, gen: torch.Generator):
        pl = init_plan(m, cfg, device=state.q.device)
        acts, rs, bests = [], [], []
        for _ in range(n_steps):
            pl, best = planner(state, pl, gen)
            a = pl.mean[0]
            state = step(state, a[None])
            ag = achieved_goal(m.cfg, m.tree, m.arm, state)
            rs.append(compute_reward(m.cfg, ag, state.goal)[0])
            acts.append(a)
            bests.append(best)
            pl = shift_plan(pl, cfg)
        return state, torch.stack(acts), torch.stack(rs), torch.stack(bests)

    return run

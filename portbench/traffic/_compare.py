"""The numbers that decide `correct`: what the timed path produced against
what the plain reference computes from the same inputs. Each is a gap or a
count that a sound run keeps small; the workload file gives its limit.
"""
from __future__ import annotations

import torch

POSITION_FIELDS = ("q", "obj_pos", "obj_quat", "art_q")


def packed_state(state, cfg, tree):
    """(NF, B) float32 of an EnvState of the program, in the kernel's row
    order (the benchmark packs it itself)."""
    from ..pools import field_rows
    B = state.q.shape[0]
    return torch.cat([getattr(state, n).reshape(B, -1).T.float()
                      for n, _ in field_rows(cfg, tree)])


def position_rows(cfg, tree, device):
    from ..pools import field_rows
    return torch.tensor([n in POSITION_FIELDS for n, r in
                         field_rows(cfg, tree) for _ in range(r)],
                        device=device)


def _q(x, q):
    """The q-quantile of x, a NaN counted as an infinite gap."""
    x = torch.nan_to_num(x.flatten().double(), nan=float("inf"))
    return float(torch.quantile(x, q))


def nonfinite(*ts):
    return int(sum(int((~torch.isfinite(t)).sum()) for t in ts))


def rollout_numbers(cfg, tree, got, ref, prefix=1):
    """got and ref each (final states (NF, B), achieved goals (B, H, ag),
    rewards (B, H), step counters (B,)): the program's and the
    reference's. Free-running over H steps two float32 roundings of this
    physics part ways in a few envs (a branch of the IK or of a contact
    flips), so every env is held to the widest gap only over the first
    `prefix` steps, before such flips; over all steps the 99th percentile
    and the final state's medians are compared. The rewards are held
    exactly to the reference's rewards of the program's own achieved
    goals."""
    from ..reference.rewards import compute_reward
    X, ags, rew, t = got[:4]
    Xr, agr, _, tr, goal = ref
    d_ag = (ags - agr).abs().amax(-1)                       # (B, H)
    pos = position_rows(cfg, tree, X.device)
    d_fin = (X - Xr).abs()
    return {
        "nonfinite": nonfinite(X, ags, rew),
        "t_wrong": int((t.long() != tr.long()).sum()),
        "ags_prefix_max": _q(d_ag[:, :prefix], 1.0),
        "ags_p99": _q(d_ag, 0.99),
        "final_pos_median": _q(d_fin[pos].amax(0), 0.5),
        "final_vel_median": _q(d_fin[~pos].amax(0), 0.5),
        "reward_wrong": int((compute_reward(cfg, ags, goal[:, None, :])
                             != rew).sum()),
    }


def rollout_gaps(got, ref):
    """Readings behind rollout_numbers that are not compared: each step's
    widest gap over the envs and its 99.9th percentile, and the share of
    envs whose widest gap over the horizon passes 1e-3."""
    d_ag = (got[1] - ref[1]).abs().amax(-1)                 # (B, H)
    d_ag = torch.nan_to_num(d_ag.double(), nan=float("inf"))
    return {"step_max": [float(x) for x in d_ag.amax(0)],
            "step_p999": [float(x) for x in torch.quantile(d_ag, 0.999, 0)],
            "envs_off_1e-3": float((d_ag.amax(1) > 1e-3).double().mean())}


def _plan_gaps(got, ref):
    """Each checked step's widest plan gap, and its best cost's gap as a
    share of the reference's, a NaN counted as an infinite gap."""
    plan = (got[0] - ref[0]).abs().flatten(1).amax(1)
    cost = (got[1] - ref[1]).abs() / ref[1].abs().clamp_min(1e-6)
    return (torch.nan_to_num(plan.double(), nan=float("inf")),
            torch.nan_to_num(cost.double(), nan=float("inf")))


def mpc_numbers(cfg, tree, arm, got, ref):
    """got and ref each (the planner's plans (k, H, A), best costs (k,), the
    executed step's states (NF, k), rewards (k,), the plans that hold the
    episodes' start poses (E, H, A)): the program's and the reference's;
    ref[5] the checked steps' goals. The reference replans from the
    program's own state and plan with the same normals and executes the
    program's own action. Plans are compared at the median over the
    checked steps of each step's widest gap: sound runs part at a few
    steps, where one preview of the population flips and MPPI's weights
    follow it (PERF.md). The executed states and the start plans are
    compared at their widest gap. The best costs are read (mpc_gaps), not
    compared: no fault at the cell's size moves them apart from sound
    runs' flips (PERF.md)."""
    mean, best, X2, rew = got[:4]
    plan, _ = _plan_gaps(got, ref)
    return {
        "nonfinite": nonfinite(*got[:4]),
        "plan_gap_median": float(torch.quantile(plan, 0.5)),
        "exec_max": _q((X2 - ref[2]).abs(), 1.0),
        "reward_wrong": reward_wrong(cfg, tree, arm, X2, rew, ref[5]),
        "start_plan_max": _q((got[4] - ref[4]).abs(), 1.0),
    }


def mpc_gaps(got, ref):
    """Readings behind mpc_numbers that are not compared: each checked
    step's widest plan gap and relative best-cost gap."""
    plan, cost = _plan_gaps(got, ref)
    return {"plan_step_max": [float(x) for x in plan],
            "best_cost_rel": [float(x) for x in cost]}


def reward_wrong(cfg, tree, arm, X, rew, goal):
    """Rewards (k,) of the program's states X (NF, k) that differ from the
    reference's rewards of the same states: an exact comparison."""
    from ..reference import twin
    from ..reference.rewards import compute_reward
    ag = twin.make_lane_ag(cfg, tree, arm)(X).T
    return int((compute_reward(cfg, ag, goal) != rew).sum())


def hold_plan(cfg, tree, arm, X, horizon):
    """The plan (k, H, A) that holds each start pose of X (NF, k): the
    reference's reading of the program's init_plan_from_state."""
    from ..reference import twin
    k, na = X.shape[1], arm.n_arm
    q = X[:tree.n_dof]
    zero = torch.zeros((1, k), dtype=X.dtype, device=X.device)
    at = cfg.action_type
    if not at.startswith("absolute"):
        hold = torch.zeros((cfg.action_dim, k), dtype=X.dtype,
                           device=X.device)
    elif at == "absolute_joints":
        hold = torch.cat([q[:na], zero])
    else:
        pos_l, quat_l = twin.lane_fk_links(tree, q)
        pos, quat = twin._lane_site_pose(tree, pos_l, quat_l, arm.ee_site)
        if at == "absolute_quat":
            orn = [quat] if cfg.use_orientation else []
        else:
            orn = [twin.lane_quat_to_euler(quat)]
        hold = torch.cat([pos] + orn + [zero])
    return hold.T[:, None, :].expand(k, horizon, hold.shape[0])

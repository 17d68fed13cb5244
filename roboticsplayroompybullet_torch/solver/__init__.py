"""Sampling MPC over the fused rollout kernel and its task-competence eval
(port of the single-device paths of roboticsplayroompybullet_tpu/solver)."""
from .cost import CostWeights, goal_distance, trajectory_cost
from .mpc import (MPCConfig, PlanState, init_plan, init_plan_from_state,
                  init_batched_plan, shift_plan, plan, mpc_rollout,
                  make_fused_planner, make_batched_fused_mpc_step,
                  make_fused_mpc_rollout)
from .eval import (GOAL_FAMILIES, PICK_FAMILY, family_goals,
                   family_site_params, make_play_cost, make_pick_cost,
                   pick_params, eval_family, eval_pick, run_eval)

__all__ = [
    "CostWeights", "goal_distance", "trajectory_cost",
    "MPCConfig", "PlanState", "init_plan", "init_plan_from_state",
    "init_batched_plan", "shift_plan", "plan", "mpc_rollout",
    "make_fused_planner",
    "make_batched_fused_mpc_step", "make_fused_mpc_rollout",
    "GOAL_FAMILIES", "PICK_FAMILY", "family_goals", "family_site_params",
    "make_play_cost", "make_pick_cost", "pick_params", "eval_family",
    "eval_pick", "run_eval",
]

"""Sampling MPC over the fused rollout kernel (port of the single-device
paths of roboticsplayroompybullet_tpu/solver)."""
from .cost import CostWeights, goal_distance, trajectory_cost
from .mpc import (MPCConfig, PlanState, init_plan, init_plan_from_state,
                  init_batched_plan, shift_plan, plan, mpc_rollout,
                  make_fused_planner, make_batched_fused_mpc_step,
                  make_fused_mpc_rollout)

__all__ = [
    "CostWeights", "goal_distance", "trajectory_cost",
    "MPCConfig", "PlanState", "init_plan", "init_plan_from_state",
    "init_batched_plan", "shift_plan", "plan", "mpc_rollout",
    "make_fused_planner",
    "make_batched_fused_mpc_step", "make_fused_mpc_rollout",
]

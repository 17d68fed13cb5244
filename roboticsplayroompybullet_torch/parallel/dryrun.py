"""The multi-device dryrun (counterpart of __graft_entry__.py::
dryrun_multichip): one pass of every sharded path on tiny shapes.

Exercises the framework's parallelism plan over an n-device mesh:
  * the env batch sharded over the mesh (make_sharded_step),
  * the MPC population sharded over the mesh with its MIN / SUM /
    all-gather reductions: CEM through make_sharded_planner, MPPI through
    the fused planner (make_sharded_fused_planner, the preview `rollout`
    kernel on the card),
  * a 2-D ("dcn", "env") mesh when n is even and at least 4.
JAX's compile canary and persistent compile cache have no counterpart:
the port compiles its one kernel source once (ops/cuda_build.py).
"""
from __future__ import annotations

import torch

from ..envs import core
from ..envs.config import CATALOG
from ..envs.state import EnvState
from ..solver import mpc
from . import mesh as M
from . import rollout as R

FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the sharded env step at B = 2n, the sharded CEM planner (H=2,
    pop=2n, 1 iteration) and the sharded fused MPPI planner (H=2,
    pop=128n, 1 iteration, 2 substeps, preview IK 2 / solve 4) on the
    flagship, every rank of an n-rank world calling it. Returns this
    rank's results: the stepped shard's rewards, each planner's plan and
    best cost."""
    n_hosts = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = M.make_mesh(n_devices=n_devices, n_hosts=n_hosts, device=device)
    dev = M.mesh_device(mesh)
    m = core.build_model(CATALOG[FLAGSHIP])

    # the env batch, reset alike on every rank, sharded over the mesh
    B = 2 * n_devices
    states, _ = R.batched_reset(m, torch.Generator(device=dev).manual_seed(0),
                                B, device=dev)
    states = M.shard_batch(states, mesh)
    actions = torch.zeros((B // n_devices, m.cfg.action_dim), device=dev)
    states2, _, rewards, _ = R.make_sharded_step(m, mesh)(states, actions)
    st0 = EnvState(**{k: v[:1] for k, v in
                      vars(M.gather_batch(states2, mesh)).items()})

    cem = mpc.MPCConfig(horizon=2, pop=2 * n_devices, iters=1,
                        algorithm="cem")
    plan_cem, best_cem = mpc.make_sharded_planner(m, cem, mesh)(
        st0, mpc.init_plan(m, cem, device=dev),
        torch.Generator(device=dev).manual_seed(2))

    fused = mpc.MPCConfig(horizon=2, pop=128 * n_devices, iters=1,
                          algorithm="mppi", preview_ik_iters=2,
                          preview_solve_iters=4)
    plan_f, best_f = mpc.make_sharded_fused_planner(
        m, fused, mesh, n_substeps=2)(
        st0, mpc.init_plan(m, fused, device=dev),
        torch.Generator(device=dev).manual_seed(4))
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "rewards": rewards, "cem_plan": plan_cem, "cem_best": best_cem,
            "fused_plan": plan_f, "fused_best": best_f}

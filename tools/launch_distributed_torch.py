"""Multi-process launcher of the PyTorch port: torch.distributed → mesh →
checkpointed MPC loop (counterpart of tools/launch_distributed.py).

One process per card (rank), each its own copy of the controlled env:

  1. The process group starts under torchrun (RANK / WORLD_SIZE /
     LOCAL_RANK / MASTER_ADDR), or from --coordinator host:port
     --num-processes N --process-id i (tcp:// rendezvous), or alone as a
     world of one. NCCL on the card; gloo with --device cpu, which runs
     the plain PyTorch twin and is only for tests. The mesh is
     ("dcn", "env"): nodes x the cards of a node (1-D "env" on one node).
  2. State and plan restore from the checkpoint if there is one, so a
     failed set of processes is relaunched with the same command line and
     the run continues from the last stride.
  3. The receding-horizon loop replans with the population-sharded fused
     planner (solver/mpc.py::make_sharded_fused_planner: each rank one
     preview `rollout` launch per iteration on pop / world candidates, the
     MPPI statistics all-reduced), executes the plan's first action
     (core.step_physics_only: one `step` launch), and rank 0 checkpoints
     {"state", "plan", "step"} every --ckpt-every steps in the JAX
     launcher's file layout (utils/checkpoint.py; atomic rename).

One card:
    python tools/launch_distributed_torch.py --steps 2 --dryrun
One node, 8 cards:
    torchrun --nproc-per-node 8 tools/launch_distributed_torch.py ...
Several nodes (one command per node, a shared --ckpt path):
    torchrun --nnodes 2 --nproc-per-node 8 --node-rank $NODE \\
        --master-addr host0 --master-port 8476 \\
        tools/launch_distributed_torch.py ...
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-process without "
                         "torchrun)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--steps", type=int, default=25,
                    help="control steps to run (total, incl. restored)")
    ap.add_argument("--pop", type=int, default=1024,
                    help="global MPC population (a multiple of the devices)")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh of the first N ranks (one node; default all)")
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "playroom_mpc_ckpt.npz"))
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny shapes + reduced physics (CI / smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL) or cpu (gloo, the plain twin)")
    return ap.parse_args(argv)


def initialize(args) -> None:
    """Start the process group: torchrun's environment, or --coordinator
    for several processes, or a world of one."""
    from roboticsplayroompybullet_torch.parallel import mesh as M
    if args.num_processes > 1 and "RANK" not in os.environ:
        M.initialize(args.device, init_method=f"tcp://{args.coordinator}",
                     rank=args.process_id, world_size=args.num_processes)
    else:
        M.initialize(args.device)


def build_mesh(args):
    """("dcn", "env") mesh over nodes x the cards of a node (torchrun's
    LOCAL_WORLD_SIZE; one card a process with --coordinator); the 1-D
    ("env",) mesh on one node."""
    import torch.distributed as dist
    from roboticsplayroompybullet_torch.parallel import mesh as M
    initialize(args)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               1 if args.num_processes > 1 else world))
    n_hosts = world // local
    if n_hosts > 1:
        return M.make_mesh(n_hosts=n_hosts, device=args.device)
    return M.make_mesh(n_devices=args.devices, device=args.device)


def _step_seed(seed: int, t: int) -> int:
    """The generator seed of control step t: a function of (seed, t) only,
    so a resumed run draws what an uninterrupted one would."""
    return int(np.random.SeedSequence([seed, t]).generate_state(1)[0])


def snapshot(state, plan, step: int) -> dict:
    """{"state", "plan", "step"} as the JAX launcher's checkpoint holds
    it: leaves in jax.tree_util order (plan's mean, sigma; the state's
    fields in EnvState order; the step), one env without a batch axis, in
    the JAX package's dtypes."""
    from roboticsplayroompybullet_torch import interop
    st = interop.state_to_numpy(state)
    tree = {"plan.mean": plan.mean, "plan.sigma": plan.sigma}
    tree.update({f"state.{f}": st[f][0] for f in interop.FIELDS})
    tree["step"] = np.int32(step)
    return tree


def restore(path: str, state, plan):
    """(state, plan, step) from a checkpoint in the JAX launcher's layout
    (written by either launcher), on the devices of `state` and `plan`."""
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs.state import EnvState
    from roboticsplayroompybullet_torch.solver import mpc
    from roboticsplayroompybullet_torch.utils import checkpoint as ckpt
    template = {"plan.mean": plan.mean, "plan.sigma": plan.sigma}
    template.update({f"state.{f}": getattr(state, f)[0]
                     for f in interop.FIELDS})
    template["step"] = torch.zeros((), dtype=torch.int32)
    snap = ckpt.load_pytree(path, template)
    st = EnvState(**{f: snap[f"state.{f}"][None] for f in interop.FIELDS})
    return (st, mpc.PlanState(snap["plan.mean"], snap["plan.sigma"]),
            int(snap["step"]))


def run_loop(args, mesh=None) -> dict:
    """The checkpointed control loop. Returns a summary dict (for tests)."""
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs.obs import achieved_goal
    from roboticsplayroompybullet_torch.envs.rewards import compute_reward
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.solver import mpc
    from roboticsplayroompybullet_torch.utils import checkpoint as ckpt

    if mesh is None:
        mesh = build_mesh(args)
    summary = {"mesh": dict(zip(mesh.mesh_dim_names,
                                (int(n) for n in mesh.mesh.shape)))}
    rank = M.mesh_rank(mesh)
    if rank is None:                       # --devices left this rank out
        return dict(summary, steps_run=0, start=None, final_reward=None)
    dev = M.mesh_device(mesh)

    m = core.build_model(CATALOG[args.env])
    dry = dict(n_substeps=2) if args.dryrun else {}
    cfg = mpc.MPCConfig(
        horizon=args.horizon, pop=args.pop, iters=args.iters,
        algorithm="mppi",
        **({"preview_ik_iters": 2, "preview_solve_iters": 4}
           if args.dryrun else {}))
    planner = mpc.make_sharded_fused_planner(m, cfg, mesh, **dry)

    # ---- restore-or-init --------------------------------------------
    state0, _ = core.reset(m, torch.Generator(device=dev).manual_seed(
        args.seed), 1, device=dev)
    plan0 = mpc.init_plan(m, cfg, device=dev)
    if os.path.exists(args.ckpt):
        state, plan_state, start = restore(args.ckpt, state0, plan0)
        print(f"[launch] restored {args.ckpt} at step {start}", flush=True)
    else:
        state, plan_state, start = state0, plan0, 0

    # ---- receding-horizon loop with periodic checkpoints ------------
    rewards = []
    with torch.no_grad():
        for t in range(start, args.steps):
            gen = torch.Generator(device=dev).manual_seed(
                _step_seed(args.seed, t))
            plan_state, best = planner(state, plan_state, gen)
            state = core.step_physics_only(m, state, plan_state.mean[:1])
            ag = achieved_goal(m.cfg, m.tree, m.arm, state)
            rewards.append(compute_reward(m.cfg, ag, state.goal)[0])
            plan_state = mpc.shift_plan(plan_state, cfg)
            if rank == 0 and (t + 1) % args.ckpt_every == 0:
                ckpt.save_pytree(args.ckpt, snapshot(state, plan_state, t + 1))
                print(f"[launch] step {t + 1}/{args.steps} "
                      f"best_cost={float(best):.3f} r={float(rewards[-1]):.2f}"
                      f" → {args.ckpt}", flush=True)

    return dict(summary, steps_run=args.steps - start, start=start,
                final_reward=float(rewards[-1]) if rewards else None)


def main(argv=None):
    import torch.distributed as dist
    args = parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.ckpt)), exist_ok=True)
    try:
        out = run_loop(args)
        print(f"[launch] done: {out}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

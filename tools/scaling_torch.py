"""Throughput scaling of the PyTorch port's sharded rollout against the
mesh size (counterpart of tools/scaling.py).

Weak scaling: each of N ranks rolls --per-device envs through
parallel/rollout.py::make_sharded_rollout (one `rollout` kernel launch a
rank, no collective), for each N of --devices that the world holds; a
mesh size above the world prints {"devices": N, "skipped": "not enough
devices"}. Run it with one process per card:

  torchrun --nproc-per-node 8 tools/scaling_torch.py [--env pandaPick-v0]
      [--horizon 10] [--per-device 64] [--devices 1 2 4 8] [--out F]

Rank 0 prints one JSON line per mesh size:
  {"devices": N, "mesh": {...}, "batch": B, "rollouts_per_s": X,
   "efficiency": f}
with the time of a size the slowest rank's best of --reps. --out writes
the rows as JSON (SCALING_TORCH.json; the JAX package's SCALING.json is
its own). --device cpu runs the plain twin on gloo (tests only).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="pandaPick-v0")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--per-device", type=int, default=64,
                    help="envs per device (weak scaling)")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL) or cpu (gloo, the plain twin)")
    ap.add_argument("--out", default=None,
                    help="also write the rows as JSON here "
                         "(SCALING_TORCH.json)")
    return ap.parse_args(argv)


def measure(args) -> list:
    """The rows, on rank 0 (an empty list elsewhere); every rank of the
    world calls it."""
    import torch.distributed as dist
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.parallel import rollout as R
    from roboticsplayroompybullet_torch.utils.profiling import timeit

    M.initialize(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    m = core.build_model(CATALOG[args.env])
    H, A = args.horizon, m.cfg.action_dim
    base_rate, rows = None, []
    for nd in args.devices:
        if nd > world:
            if rank == 0:
                print(json.dumps({"devices": nd,
                                  "skipped": "not enough devices"}))
            continue
        mesh = M.make_mesh(n_devices=nd, device=args.device)
        dev, idx = M.mesh_device(mesh), M.mesh_rank(mesh)
        secs = torch.zeros((), dtype=torch.float64, device=dev)
        if idx is not None:
            B = args.per_device
            # this rank's block of the global batch, from its own seed
            gen = torch.Generator(device=dev).manual_seed(idx)
            states, _ = R.batched_reset(m, gen, B, device=dev)
            acts = iter([(torch.rand((B, H, A), generator=gen, device=dev)
                          - 0.5) * 0.5 for _ in range(args.reps + 1)])
            roll = R.make_sharded_rollout(m, mesh)
            with torch.no_grad():
                secs.fill_(timeit(lambda: roll(states, next(acts)),
                                  warmup=1, reps=args.reps))
        # a mesh takes its slowest rank's time (ranks off the mesh add 0)
        dist.all_reduce(secs, dist.ReduceOp.MAX)
        rate = args.per_device * nd / float(secs)
        if base_rate is None:
            base_rate = rate / nd
        row = {"devices": nd,
               "mesh": dict(zip(mesh.mesh_dim_names,
                                (int(n) for n in mesh.mesh.shape))),
               "batch": args.per_device * nd,
               "rollouts_per_s": rate,
               "efficiency": rate / (base_rate * nd)}
        if rank == 0:
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    import torch.distributed as dist
    args = parse_args(argv)
    try:
        rows = measure(args)
        if args.out and dist.get_rank() == 0:
            name = (torch.cuda.get_device_name(0)
                    if args.device != "cpu" else "cpu")
            with open(args.out, "w") as f:
                json.dump({"meta": {"env": args.env,
                                    "horizon": args.horizon,
                                    "per_device": args.per_device,
                                    "reps": args.reps, "device": name,
                                    "weak_scaling": True},
                           "rows": rows}, f, indent=1)
            print(f"wrote {os.path.abspath(args.out)}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

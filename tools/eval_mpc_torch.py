"""Task-competence eval CLI of the PyTorch port: the fused MPC planner
against the playroom goal families, on one NVIDIA card.

Runs roboticsplayroompybullet_torch/solver/eval.py's sweep (reach / block /
drawer / door / button / dial / pick on the UR5 flagship, UR5Reach-v0 and
pandaPick-v0, then the five play families on the Panda playroom, keys
prefixed panda_; success semantics per playRewardFunc.py:16-77) through
the port's CUDA kernels and writes EVAL_TORCH.json in EVAL.json's schema
(read by tests/test_torch_eval_artifact.py), plus a table to stdout. Each
family record adds reset_s, the share of its wall_s spent in resets.

    python tools/eval_mpc_torch.py                  # full sweep on the card
    python tools/eval_mpc_torch.py --families button drawer --episodes 8
    python tools/eval_mpc_torch.py --device cpu --substeps 1 --pop 8 \\
        --horizon 2 --iters 1 --steps 2 --episodes 2 --n-envs 2 \\
        --out /tmp/e.json                           # CPU smoke (plain twin)

Population 1024/env x 4 envs = 4096 kernel lanes per preview launch, as
tools/eval_mpc.py sweeps the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def card_name_and_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", nargs="+",
                    default=["reach", "block", "drawer", "door", "button",
                             "dial", "pick"])
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--panda-env", default="pandaPlayAbsRPY1Obj-v0",
                    help="second play sweep on the Panda arm; results are "
                         "prefixed panda_ (pass --panda-families with no "
                         "names to skip)")
    ap.add_argument("--panda-families", nargs="*",
                    default=["block", "drawer", "door", "button", "dial"])
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--n-envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--pop", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--sigma", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain PyTorch twin (smoke only)")
    ap.add_argument("--substeps", type=int, default=None,
                    help="reduced-substep physics (CPU smoke only)")
    ap.add_argument("--out", default=None,
                    help="write JSON results here (default: repo "
                         "EVAL_TORCH.json)")
    args = ap.parse_args(argv)

    import torch
    from roboticsplayroompybullet_torch import solver as sol

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu for the plain twin")
    mpc = sol.MPCConfig(horizon=args.horizon, pop=args.pop, iters=args.iters,
                        algorithm="mppi", sigma_init=args.sigma)
    kw = dict(mpc=mpc, n_episodes=args.episodes, n_envs=args.n_envs,
              n_steps=args.steps, seed=args.seed, n_substeps=args.substeps,
              device=args.device, verbose=True)
    t0 = time.perf_counter()
    results = sol.run_eval(tuple(args.families), env_id=args.env, **kw)
    if args.panda_env and args.panda_families:
        panda = sol.run_eval(tuple(args.panda_families),
                             env_id=args.panda_env, **kw)
        results.update({f"panda_{k}": v for k, v in panda.items()})
    total = time.perf_counter() - t0

    gpu = args.device == "cuda"
    meta = {
        "env": args.env,
        "panda_env": args.panda_env if args.panda_families else None,
        "pick_env": sol.eval.PICK_ID if "pick" in args.families else None,
        "mpc": {"horizon": args.horizon, "pop": args.pop,
                "iters": args.iters, "sigma": args.sigma,
                "algorithm": "mppi",
                "preview_ik_iters": mpc.preview_ik_iters,
                "preview_solve_iters": mpc.preview_solve_iters},
        "n_episodes": args.episodes, "n_steps": args.steps,
        "n_envs": args.n_envs, "seed": args.seed,
        "n_substeps": args.substeps,
        "backend": "cuda" if gpu else "reference",
        "platform": "cuda" if gpu else "cpu",
        "device": torch.cuda.get_device_name(0) if gpu else "cpu",
        "nvidia_smi": card_name_and_limit() if gpu else None,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "total_s": round(total, 1),
    }
    out = {"meta": meta, "families": results}
    path = args.out or os.path.join(os.path.dirname(__file__), "..",
                                    "EVAL_TORCH.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n{'family':13s} {'success':>8s}  episodes  wall_s  resets")
    for fam, r in results.items():
        print(f"{fam:13s} {r['success_rate']:8.3f}  "
              f"{r['n_success']:2d}/{r['n_episodes']:<5d} {r['wall_s']:7.1f}"
              f"  {r['reset_s']:.1f} s "
              f"({100 * r['reset_s'] / max(r['wall_s'], 1e-9):.0f} %)")
    n_ok = sum(r["n_success"] for r in results.values())
    n_ep = sum(r["n_episodes"] for r in results.values())
    print(f"pooled {n_ok}/{n_ep} = {n_ok / n_ep:.3f} in {total:.1f} s; "
          f"{meta['nvidia_smi'] or 'cpu'}")
    print(f"wrote {os.path.abspath(path)}")


if __name__ == "__main__":
    main()

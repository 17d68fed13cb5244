"""Train a goal-conditioned BC policy from a collected play log, on one
NVIDIA card (the PyTorch port's counterpart of tools/train_lfp.py).

End-to-end LfP data path (the reference's downstream use, reference
README.md:2-10): tools/collect_play_torch.py writes the native episode
log; this script replays relabelled windows (the in-RAM sampler, each
batch copied to the card) and trains π(a | obs, goal) with Adam.

  python tools/collect_play_torch.py --batch 2048 --steps 200 \\
      --out build/lfp/play.elog
  python tools/train_lfp_torch.py --log build/lfp/play.elog \\
      --steps 15000 --hidden 512 512 --out build/lfp/policy.npz

The goal field defaults to full_positional_state, the goal space of
tools/eval_lfp_torch.py (tools/train_lfp.py's default is achieved_goal).
The policy is saved with the port's save_pytree in flax's leaf order, so
the JAX package's tools/eval_lfp.py loads it too; the fields it was
trained on and the stage's times go to <out>.stats.json, which the eval
reads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def read_schema(log: str, schema):
    """The log's field names: <log>.fields.json when the collector wrote
    it, else `schema`."""
    sidecar = log + ".fields.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            schema = json.load(f)
        print(f"schema from {sidecar}: {schema}")
    return list(schema)


def action_high(env: str, dim: int):
    """The env's action box (e.g. abs-RPY pose dims are ±6,
    environments.py:88-117): a unit box cannot express the data."""
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    high = list(CATALOG[env].action_high) if env in CATALOG else [1.0] * dim
    assert len(high) == dim, (env, high, dim)
    return high


def train(sampler, dims, high, steps: int, batch: int, window: int,
          lr: float, hidden, seed: int, device="cuda", log_every: int = 100):
    """`steps` Adam steps on batches from `sampler` (make_memory_sampler's),
    each copied to `device`. dims: (obs, act, goal) widths. Returns
    (policy, losses (steps,) numpy, seconds)."""
    from roboticsplayroompybullet_torch.learn import lfp
    d_obs, d_act, d_ag = dims
    policy, opt = lfp.init_training(
        torch.Generator().manual_seed(seed), obs_dim=d_obs, goal_dim=d_ag,
        action_dim=d_act, action_high=high, lr=lr, hidden=tuple(hidden),
        device=device)
    step = lfp.make_train_step(policy, opt)
    rng = np.random.default_rng(seed)
    losses = torch.empty(steps, device=device)
    t0 = time.perf_counter()
    for i in range(steps):
        b = sampler(rng, batch, window)
        b = {k: torch.from_numpy(v).to(device, non_blocking=True)
             for k, v in b.items()}
        losses[i] = step(b)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {float(losses[i]):.5f}  "
                  f"{(i + 1) / (time.perf_counter() - t0):.1f} steps/s",
                  flush=True)
    out = losses.cpu().numpy()
    return policy, out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", default="build/lfp/play.elog")
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0",
                    help="catalog id whose action box squashes the policy "
                         "output (must match the collected data)")
    ap.add_argument("--fields", nargs=3,
                    default=["obs_quat", "action", "full_positional_state"],
                    metavar=("OBS", "ACT", "GOAL"))
    ap.add_argument("--schema", nargs="+",
                    default=["obs_quat", "achieved_goal", "desired_goal",
                             "full_positional_state", "action"],
                    help="ALL field names in file order when the log has "
                         "no .fields.json (the native log stores dims, not "
                         "names)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hidden", type=int, nargs="+", default=[256, 256])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="build/lfp/policy.npz")
    args = ap.parse_args(argv)

    from roboticsplayroompybullet_torch.learn import lfp
    from roboticsplayroompybullet_torch.utils.checkpoint import save_pytree
    from roboticsplayroompybullet_torch.utils.episodelog import EpisodeReader

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    # matmuls in full float32, as the kernel rules require
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    schema = read_schema(args.log, args.schema)
    reader = EpisodeReader(args.log, fields=schema)
    assert len(reader.names) == len(reader.dims), \
        f"--schema names {len(reader.names)} != file fields {len(reader.dims)}"
    d = {k: reader.dims[reader.names.index(k)] for k in args.fields}
    print(f"log: {reader.n_episodes} episodes, dims {d}")
    f_obs, f_act, f_ag = args.fields
    high = action_high(args.env, d[f_act])
    sampler = lfp.make_memory_sampler(reader, fields=tuple(args.fields))
    reader.close()
    load_s = time.perf_counter() - t0

    policy, losses, secs = train(
        sampler, (d[f_obs], d[f_act], d[f_ag]), high, args.steps,
        args.batch, args.window, args.lr, args.hidden, args.seed,
        args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_pytree(args.out, lfp.policy_params_to_jax(policy))
    print(f"trained {args.steps} steps in {secs:.1f} s = "
          f"{args.steps / secs:.1f} steps/s; saved policy params → "
          f"{args.out}")
    k = min(100, args.steps)
    stats = {"log": args.log, "env": args.env, "fields": args.fields,
             "steps": args.steps, "batch": args.batch,
             "window": args.window, "lr": args.lr, "hidden": args.hidden,
             "seed": args.seed, "device": args.device, "load_s": load_s,
             "train_s": secs, "train_steps_per_s": args.steps / secs,
             "loss_first": float(losses[:k].mean()),
             "loss_last": float(losses[-k:].mean())}
    with open(args.out + ".stats.json", "w") as f:
        json.dump(stats, f, indent=1)


if __name__ == "__main__":
    main()

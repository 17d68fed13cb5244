"""Collect play episodes into the native episode log, on one NVIDIA card
(the PyTorch port's counterpart of tools/collect_play.py).

The reference's workflow: a human teleoperates the playroom via VR and
episodes are written for learning_from_play (reference README.md:2-10).
The port collects BATCHED play data — thousands of envs in lockstep on the
card — from the structured play actor (learn/play_policy.py), the legacy
raw-box AR(1) process, or a receding-horizon MPPI controller.

  python tools/collect_play_torch.py --env UR5PlayAbsRPY1Obj-v0 \\
      --policy play --batch 2048 --steps 200 --out build/lfp/play.elog

play / random: batched_reset of B envs, then T steps of the actor → one
`step` kernel launch (parallel/fused.py::make_fused_batched_step) →
calc_obs, the continuity buffers threaded back into the state. The T x B
observations stay on the card and are copied to the host once, at the
end. mppi: one env, make_fused_planner (`rollout` launches) and
core.step. --device cpu runs the plain PyTorch twin (tests only).

Fields per step, in this order: obs_quat, achieved_goal, desired_goal,
full_positional_state, action — the LfP replay schema
(environments.py:849-861). Row t is (obs after a_t, a_t). The field
names go to <out>.fields.json (the native log stores dims only), the
stage's times to <out>.stats.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

PUBLIC = ("obs_quat", "achieved_goal", "desired_goal",
          "full_positional_state")


def _write_fields_sidecar(out_path: str, fields):
    """<out>.fields.json: the field-name order of the log;
    tools/train_lfp_torch.py and the JAX tools load it instead of trusting
    a hand-typed --schema."""
    with open(out_path + ".fields.json", "w") as f:
        json.dump(list(fields), f)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def collect_play(m, policy: str, B: int, T: int, gen: torch.Generator,
                 device="cuda"):
    """B envs x T steps of the play (or legacy random) actor through the
    step kernel. Returns (obs {field: (T, B, d) numpy} in PUBLIC order,
    actions (T, B, A) numpy, stats {reset_s, steps_s, copy_s})."""
    from roboticsplayroompybullet_torch.envs.obs import calc_obs
    from roboticsplayroompybullet_torch.learn import play_policy
    from roboticsplayroompybullet_torch.ops.fused_step import const_on
    from roboticsplayroompybullet_torch.parallel import fused
    from roboticsplayroompybullet_torch.parallel import rollout as R

    A = m.cfg.action_dim
    stepB = fused.make_fused_batched_step(m)
    if policy == "play":
        a_init, a_step = play_policy.make_play_actor(m)
    else:
        # legacy raw-box AR(1) (kept for comparison runs)
        high = const_on(m.cfg.action_high, device)

        def a_init(g, n):
            return torch.zeros(n, A, device=device)

        def a_step(tail, g):
            eps = torch.randn(B, A, generator=g, device=device)
            tail = 0.85 * tail + 0.35 * eps
            return tail, torch.clamp(tail, -high, high)

    t0 = time.perf_counter()
    with torch.no_grad():
        st, _ = R.batched_reset(m, gen, B, device=device)
        _sync(device)
        t1 = time.perf_counter()
        ast = a_init(gen, B)
        obs_buf, act_buf = {k: [] for k in PUBLIC}, []
        for _ in range(T):
            ast, acts = a_step(ast, gen)
            st = stepB(st, acts)
            obs = calc_obs(m.cfg, m.tree, m.arm, m.scene, st)
            # thread the continuity buffers back into the carried state so
            # the quaternion sign filter compares each step against the
            # PREVIOUS step (environments.py:868-894)
            st = st.replace(prev_obs=obs["_prev_obs"],
                            prev_ag=obs["_prev_ag"],
                            has_prev=torch.ones_like(st.has_prev))
            for k in PUBLIC:
                obs_buf[k].append(obs[k])
            act_buf.append(acts)
        dev_obs = {k: torch.stack(v) for k, v in obs_buf.items()}
        dev_acts = torch.stack(act_buf)
        _sync(device)
        t2 = time.perf_counter()
        # the one read back of the collection
        out = {k: v.cpu().numpy() for k, v in dev_obs.items()}
        acts = dev_acts.cpu().numpy()
    t3 = time.perf_counter()
    return out, acts, {"reset_s": t1 - t0, "steps_s": t2 - t1,
                       "copy_s": t3 - t2}


def write_log(path: str, obs, acts):
    """The (T, B, ·) arrays as B episodes of T rows, fields in PUBLIC order
    then action (never the order of a dict that was built by iterating
    outputs), plus the sidecar. Returns the {field: dim} schema."""
    from roboticsplayroompybullet_torch.utils.episodelog import EpisodeWriter
    fields = {k: int(obs[k].shape[-1]) for k in PUBLIC}
    fields["action"] = int(acts.shape[-1])
    _write_fields_sidecar(path, fields)
    with EpisodeWriter(path, fields) as w:
        for b in range(acts.shape[1]):
            w.begin_episode()
            data = {k: obs[k][:, b] for k in PUBLIC}
            data["action"] = acts[:, b]
            w.append_batch(data)
            w.end_episode()
    return fields


def collect_mppi(m, T: int, gen: torch.Generator, path: str, device="cuda"):
    """One env, T receding-horizon MPPI steps (pop 1024, H=10, 2
    iterations), written row by row."""
    from roboticsplayroompybullet_torch import solver as sol
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.utils.episodelog import EpisodeWriter
    cfg = sol.MPCConfig(horizon=10, pop=1024, iters=2, algorithm="mppi",
                        sigma_init=0.3)
    plan_fn = sol.make_fused_planner(m, cfg)
    with torch.no_grad():
        state, obs = core.reset(m, gen, 1, device=device)
        fields = {k: int(obs[k].shape[-1]) for k in PUBLIC}
        fields["action"] = m.cfg.action_dim
        _write_fields_sidecar(path, fields)
        pl = sol.init_plan(m, cfg, device=device)
        with EpisodeWriter(path, fields) as w:
            w.begin_episode()
            for t in range(T):
                pl, best = plan_fn(state, pl, gen)
                a = pl.mean[0]
                state, obs, r, info = core.step(m, state, a[None])
                pl = sol.shift_plan(pl, cfg)
                row = {k: obs[k].cpu().numpy() for k in PUBLIC}
                row["action"] = a[None].cpu().numpy()
                w.append_batch(row)
                if t % 25 == 0:
                    print(f"t={t} r={float(r[0]):.3f} "
                          f"best={float(best):.3f}", flush=True)
            w.end_episode()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--policy", choices=["play", "random", "mppi"],
                    default="play",
                    help="play = structured EE-wander teleop analogue "
                         "(learn/play_policy.py, the LfP data source); "
                         "random = legacy raw-box AR(1); mppi = planner")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="build/lfp/play.elog")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain PyTorch twin (tests only)")
    args = ap.parse_args(argv)

    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu for the plain twin")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    m = core.build_model(CATALOG[args.env])
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    B, T = args.batch, args.steps
    if args.policy == "mppi":
        collect_mppi(m, T, gen, args.out, args.device)
        print(f"wrote 1 episode to {args.out}")
        return
    obs, acts, st = collect_play(m, args.policy, B, T, gen, args.device)
    t0 = time.perf_counter()
    write_log(args.out, obs, acts)
    st["write_s"] = time.perf_counter() - t0
    rate = B * T / (st["steps_s"] + st["copy_s"])
    print(f"collected {B} x {T} steps in {st['steps_s'] + st['copy_s']:.1f}"
          f" s = {rate:.0f} env-steps/s (reset {st['reset_s']:.1f} s, "
          f"write {st['write_s']:.1f} s)", flush=True)
    stats = dict(st, env=args.env, policy=args.policy, batch=B, steps=T,
                 seed=args.seed, device=args.device, env_steps_per_s=rate,
                 wall_s=sum(st.values()))
    with open(args.out + ".stats.json", "w") as f:
        json.dump(stats, f, indent=1)
    print(f"wrote {B} episodes of {T} steps to {args.out}")


if __name__ == "__main__":
    main()

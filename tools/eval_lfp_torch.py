"""Closed-loop evaluation of a trained LfP policy vs the play process, on
one NVIDIA card (the PyTorch port's counterpart of tools/eval_lfp.py).

Completes the learning-from-play chain (the reference's whole purpose,
reference README.md:2-10): collect play (tools/collect_play_torch.py) →
train goal-conditioned BC (tools/train_lfp_torch.py) → THIS: hindsight
window goals replayed closed-loop in the simulator.

Protocol (tools/eval_lfp.py's, pure hindsight, no state injection): reset
N fresh envs; from each start state roll the SAME structured play process
the data was collected with (learn/play_policy.py) for W steps and take
the final `full_positional_state` as the goal — reachable from the start
by construction, the window-relabel target the policy was trained on.
Then, from the SAME start states, roll (a) the policy conditioned on
those goals and (b) an INDEPENDENT play-process rollout, and compare.
Every env step is one `step` kernel launch at B=N (envs/core.py::step);
the JAX package's eval steps its vmap oracle instead, so the two
artifacts agree only statistically.

Headline metric: window-goal SUCCESS RATE — an episode succeeds if at any
step the EE is within 5 cm of the goal's arm position AND the play
achieved goal passes the reference's all-or-nothing threshold test against
the goal's scene part (playRewardFunc.py:16-77 via
envs/rewards.compute_reward). Distance ratios are secondary diagnostics.

    python tools/eval_lfp_torch.py --params build/lfp/policy.npz \\
        --episodes 256

The policy's widths come from the checkpoint's shapes, its observation
and goal fields from <params>.stats.json (tools/train_lfp_torch.py writes
both). Writes LFP_EVAL_TORCH.json in LFP_EVAL.json's schema (read by
tests/test_torch_lfp_artifact.py), with the card's name and power limit
and, under "stages", the times of the collection and training that made
the policy (their .stats.json files) beside the eval's own.
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

from eval_mpc_torch import card_name_and_limit  # noqa: E402


def score(cfg, goals: np.ndarray, gs: np.ndarray, ags: np.ndarray):
    """Window-goal metrics of one set of rollouts. goals (N, goal_dim)
    full_positional_state goals; gs (W, N, goal_dim) the rollouts' goal
    field and ags (W, N, ag_dim) their achieved goals at every step."""
    from roboticsplayroompybullet_torch.envs.rewards import compute_reward
    nag = cfg.ag_dim
    goal_ag = goals[:, goals.shape[-1] - nag:]            # scene part
    goal_ee = goals[:, 0:3]
    d = np.linalg.norm(gs - goals[None], axis=-1)          # (W, N)
    ee = np.linalg.norm(gs[..., 0:3] - goal_ee[None], axis=-1)
    # per-step play-threshold pass on the scene part (the reference's
    # all-or-nothing success test, playRewardFunc.py:16-77)
    play_ok = (compute_reward(cfg, torch.as_tensor(ags),
                              torch.as_tensor(goal_ag)[None]) >= 0.0).numpy()
    succ = (ee < 0.05) & play_ok                            # (W, N)
    return {
        "success_rate_any": float(succ.any(axis=0).mean()),
        "success_rate_final": float(succ[-1].mean()),
        "ee_within_5cm_any": float((ee < 0.05).any(axis=0).mean()),
        "play_ok_final": float(play_ok[-1].mean()),
        "final_dist_mean": float(d[-1].mean()),
        "final_dist_median": float(np.median(d[-1])),
        "best_dist_mean": float(d.min(axis=0).mean()),
        "final_ee_dist_mean_m": float(ee[-1].mean()),
    }


def evaluate(m, policy, N: int, W: int, seed: int = 0,
             obs_field: str = "obs_quat",
             goal_field: str = "full_positional_state", device="cuda"):
    """The protocol above for N episodes of W steps on `device`. Returns
    (policy metrics, play-process metrics, seconds {reset_s, rollouts_s})."""
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.learn import play_policy
    from roboticsplayroompybullet_torch.parallel.rollout import batched_reset

    t0 = time.perf_counter()
    with torch.no_grad():
        states0, obs0 = batched_reset(
            m, torch.Generator(device=device).manual_seed(seed), N, device)
    t1 = time.perf_counter()
    a_init, a_step = play_policy.make_play_actor(m)

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    @torch.no_grad()
    def run(goals, s):
        """W steps from states0 by the policy (goals given) or the play
        process (goals None) → (goal field (W, N, ·), achieved_goal
        (W, N, ag_dim)) numpy."""
        st, obs = states0, obs0
        g, ast = gen(s), a_init(gen(s + 77), N)
        gs, ags = [], []
        for _ in range(W):
            if goals is not None:
                acts = policy(obs[obs_field], goals)
            else:
                ast, acts = a_step(ast, g)
            st, obs, _, _ = core.step(m, st, acts)
            gs.append(obs[goal_field])
            ags.append(obs["achieved_goal"])
        return torch.stack(gs).cpu().numpy(), torch.stack(ags).cpu().numpy()

    # hindsight goals: final full_positional_state of a play window
    goals = run(None, seed + 1)[0][-1]
    res_pol = score(m.cfg, goals, *run(torch.as_tensor(goals, device=device),
                                       seed + 2))
    # independent play-process rollout (NOT the goal-generating one)
    res_rnd = score(m.cfg, goals, *run(None, seed + 3))
    return res_pol, res_rnd, {"reset_s": t1 - t0,
                              "rollouts_s": time.perf_counter() - t1}


def load_policy(path: str, action_high, device="cuda"):
    """(policy, train stats) of a tools/train_lfp_torch.py checkpoint: the
    widths from its leaves, the fields from <path>.stats.json. The eval
    scores in full_positional_state, so it refuses a policy trained on
    another goal field."""
    from roboticsplayroompybullet_torch.learn import lfp
    stats = _stats(path)
    if stats is None or "fields" not in stats:
        raise SystemExit(f"{path}.stats.json names no training fields: "
                         "train with tools/train_lfp_torch.py")
    if stats["fields"][2] != "full_positional_state":
        raise SystemExit(f"{path} was trained on goal field "
                         f"{stats['fields'][2]!r}; the eval conditions on "
                         "full_positional_state")
    with np.load(path) as z:
        policy = lfp.policy_from_params(z, action_high, device)
    return policy.eval(), stats


def _stats(path: str):
    if path and os.path.exists(path + ".stats.json"):
        with open(path + ".stats.json") as f:
            return json.load(f)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--params", default="build/lfp/policy.npz")
    ap.add_argument("--episodes", type=int, default=128)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain PyTorch twin (tests only)")
    ap.add_argument("--out", default=None,
                    help="default: the repo's LFP_EVAL_TORCH.json")
    args = ap.parse_args(argv)

    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG

    gpu = args.device == "cuda"
    if gpu and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu for the plain twin")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = core.build_model(CATALOG[args.env])
    policy, train = load_policy(args.params, list(m.cfg.action_high),
                                args.device)
    obs_field, _, goal_field = train["fields"]
    hidden = [layer.out_features for layer in policy.layers[:-1]]

    res_pol, res_rnd, secs = evaluate(
        m, policy, args.episodes, args.window, args.seed, obs_field,
        goal_field, args.device)
    ratio = res_pol["final_dist_mean"] / max(res_rnd["final_dist_mean"],
                                             1e-9)
    collect = _stats(train["log"])
    evals = dict(secs, episodes=args.episodes, window=args.window,
                 env_steps=3 * args.episodes * args.window,
                 env_steps_per_s=3 * args.episodes * args.window
                 / secs["rollouts_s"])
    out = {
        "meta": {"env": args.env, "episodes": args.episodes,
                 "window": args.window, "hidden": hidden,
                 "seed": args.seed, "obs_field": obs_field,
                 "goal_field": goal_field,
                 "actor": "play_policy.make_play_actor",
                 "platform": "gpu" if gpu else "cpu",
                 "device": torch.cuda.get_device_name(0) if gpu else "cpu",
                 "nvidia_smi": card_name_and_limit() if gpu else None,
                 "torch": torch.__version__, "cuda": torch.version.cuda},
        "policy": res_pol,
        "random": res_rnd,
        "final_dist_ratio_policy_over_random": round(ratio, 4),
        "success_ratio_policy_over_random": round(
            res_pol["success_rate_any"]
            / max(res_rnd["success_rate_any"], 1e-9), 2),
        "stages": {"collect": collect, "train": train, "eval": evals},
    }
    path = args.out or os.path.join(os.path.dirname(__file__), "..",
                                    "LFP_EVAL_TORCH.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"wrote {os.path.abspath(path)}")


if __name__ == "__main__":
    main()

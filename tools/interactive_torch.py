"""Interactive teleop REPL of the PyTorch port — the L6 layer of the
reference (port of tools/interactive.py).

Role parity with reference envs/interactive.py:24-61: a human drives the
arm and watches rewards. The reference uses PyBullet GUI debug sliders;
this is a terminal REPL: type deltas (or absolute targets) for
XYZ/RPY/grip, the env steps (on the card unless --device names another),
and the REPL prints the EE pose, the reward and, in a play env, the
per-element play success bits (utils/metrics.py).

  python tools/interactive_torch.py [--env UR5PlayAbsRPY1Obj-v0]
                                    [--steps-per 1] [--frame out.png]

Commands at the prompt:
  x/y/z/r/p/w <delta>   nudge EE position (m) / roll-pitch-yaw (rad)
  g <0..1>              gripper target (0 open, 1 closed)
  a <v1 v2 ...>         raw action vector passed straight to env.step
  j <q1 q2 ...>         hard-teleport arm joints (reference
                        interactive.py:41-46 joint_control: bypasses
                        dynamics via reset_arm_joints)
  j <i> <val>           teleport a single joint i to val (rad)
  goal                  resample the goal;   show  print current obs
  render                write a 200x200 RGB frame as a PNG to --frame
  human                 toggle render('human'): stream PNG frames to
                        $PLAYROOM_HUMAN_RENDER (default
                        playroom_human.png in the temporary directory)
  reset                 env.reset();         quit  exit

The first step builds the CUDA kernel (~1 min); after that every step is
interactive-rate.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--steps-per", type=int, default=1,
                    help="env steps per command (25 Hz each)")
    ap.add_argument("--device", default=None,
                    help="torch device of the env (default: the card)")
    ap.add_argument("--frame", default=os.path.join(tempfile.gettempdir(),
                                                    "interactive.png"),
                    help="where `render` writes its PNG")
    args = ap.parse_args(argv)

    import torch
    from roboticsplayroompybullet_torch.envs import wrapper
    from roboticsplayroompybullet_torch.utils import play_element_bits
    from roboticsplayroompybullet_torch.utils.render import write_png
    env = wrapper.make(args.env, device=args.device)
    obs = env.reset()
    cfg = env.cfg
    if cfg.action_type != "absolute_rpy":
        print(f"note: {args.env} uses action_type={cfg.action_type}; "
              "x/y/z/r/p/w nudges assume absolute_rpy — use 'a ...' for "
              "raw actions")

    # absolute-RPY target the nudge commands mutate (reference
    # interactive.py:6-21 slider defaults)
    tgt = np.zeros(cfg.action_dim, np.float32)
    tgt[:3] = np.asarray(obs["controllable_achieved_goal"][:3])
    if cfg.action_dim >= 7:
        tgt[3:6] = [0.0, 0.0, 0.0]
    keys = {"x": 0, "y": 1, "z": 2, "r": 3, "p": 4, "w": 5}

    def report(obs, r, info):
        ee = np.asarray(obs["controllable_achieved_goal"])[:3]
        print(f"  ee=({ee[0]:+.3f},{ee[1]:+.3f},{ee[2]:+.3f}) "
              f"r={float(r):+.2f} success={float(info['is_success']):.0f}")
        if cfg.play:
            bits = play_element_bits(cfg, torch.as_tensor(
                obs["achieved_goal"]), torch.as_tensor(obs["desired_goal"]))
            print("  " + " ".join(f"{k}={int(v)}" for k, v in bits.items()))

    print(f"{args.env} ready — commands: x/y/z/r/p/w <d>, g <v>, a <...>, "
          "j <...>, goal, show, render, human, reset, quit")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            continue
        tok = line.split()
        cmd = tok[0].lower()
        if cmd == "quit":
            break
        elif cmd == "reset":
            obs = env.reset()
            tgt[:3] = np.asarray(obs["controllable_achieved_goal"][:3])
            continue
        elif cmd == "goal":
            env.reset_goal_pos(None)
            print("  goal:", env.state.goal[0].cpu().numpy().round(3))
            continue
        elif cmd == "show":
            for k, v in obs.items():
                print(f"  {k}: {np.asarray(v).round(3)}")
            continue
        elif cmd == "render":
            write_png(args.frame, env.render("rgb_array"))
            print(f"  wrote {args.frame}")
            continue
        elif cmd == "j":
            n_arm = env.model.arm.n_arm
            vals = [float(v) for v in tok[1:]]
            if len(vals) == 2 and vals[0] == int(vals[0]) \
                    and 0 <= int(vals[0]) < n_arm:
                poses = env.state.q[0, :n_arm].cpu().numpy().copy()
                poses[int(vals[0])] = vals[1]
            elif len(vals) >= n_arm:
                poses = np.asarray(vals[:n_arm], np.float32)
            else:
                print(f"  j needs {n_arm} joint values or '<i> <val>'")
                continue
            env.reset_arm_joints(poses)
            print("  q[:%d] = %s" % (n_arm, np.round(poses, 3)))
            continue
        elif cmd == "human":
            if env.render_scene:
                env.render_scene = False
            else:
                env.render("human")
            print(f"  human-render {'ON' if env.render_scene else 'OFF'} "
                  f"→ {env.human_render_path}")
            continue
        elif cmd == "a":
            act = np.asarray([float(v) for v in tok[1:]], np.float32)
        elif cmd in keys and len(tok) == 2:
            tgt[keys[cmd]] += float(tok[1])
            act = tgt.copy()
        elif cmd == "g" and len(tok) == 2:
            tgt[-1] = float(tok[1])
            act = tgt.copy()
        else:
            print("  ?")
            continue
        for _ in range(args.steps_per):
            obs, r, done, info = env.step(act)
        report(obs, r, info)


if __name__ == "__main__":
    main()

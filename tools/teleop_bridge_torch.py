"""State-injection teleop bridge: drive a PlayEnv of the PyTorch port over
JSON lines (port of tools/teleop_bridge.py, the same protocol).

The reference's VR teleop attaches a SHARED_MEMORY bullet client to a
running VR server (reference environments.py:252-267, README.md:10). The
transport stays out of scope; this bridge is the state-injection surface
that replaces it: an external teleop process (VR rig, joystick daemon,
scripted client) speaks newline-delimited JSON over stdin/stdout (or a TCP
socket) and the bridge drives one `PlayEnv`, on the card unless --device
names another, through exactly the APIs the reference's data-collection
rig used — `reset(o)`, `step(action)`, `reset_goal_pos(goal)`
(environments.py:173-191).

Protocol (one JSON object per line):
  {"cmd": "reset"}                          → {"ok": true, "obs": {...}}
  {"cmd": "reset", "o": [...]}              → state injection reset
  {"cmd": "step", "action": [...]}          → {"ok": true, "obs": {...},
                                               "reward": r, "info": {...}}
  {"cmd": "goal", "goal": [...]}            → reset_goal_pos(goal)
  {"cmd": "goal"}                           → resample goal
  {"cmd": "sub_goal", "sub_goal": [...], "kind": "..."}  → visualise
  {"cmd": "del_sub_goal"}
  {"cmd": "state"}                          → current obs dict
  {"cmd": "close"}                          → bridge exits

Run:  python tools/teleop_bridge_torch.py --env UR5PlayAbsRPY1Obj-v0
      python tools/teleop_bridge_torch.py --port 8765   # TCP, not stdio
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return float(x)
    return x


class Bridge:
    """One env, one command at a time, on `device` (the card unless the
    caller names another). Pure request/response; no hidden state beyond
    the env."""

    def __init__(self, env_id: str, seed: int = 0, device=None):
        from roboticsplayroompybullet_torch.envs.wrapper import make
        self.env = make(env_id, seed=seed, device=device)
        self._last_obs = None

    def handle(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        try:
            if cmd == "reset":
                o = msg.get("o")
                obs = self.env.reset(
                    o=None if o is None else np.asarray(o, np.float32))
                self._last_obs = obs
                return {"ok": True, "obs": _jsonable(obs)}
            if cmd == "step":
                obs, r, done, info = self.env.step(
                    np.asarray(msg["action"], np.float32))
                obs.pop("img", None)
                self._last_obs = obs
                return {"ok": True, "obs": _jsonable(obs),
                        "reward": float(r), "done": bool(done),
                        "info": _jsonable(info)}
            if cmd == "goal":
                g = msg.get("goal")
                self.env.reset_goal_pos(
                    None if g is None else np.asarray(g, np.float32))
                return {"ok": True,
                        "goal": self.env.state.goal[0].tolist()}
            if cmd == "sub_goal":
                self.env.visualise_sub_goal(
                    np.asarray(msg["sub_goal"], np.float32),
                    msg.get("kind", "full_positional_state"))
                return {"ok": True}
            if cmd == "del_sub_goal":
                self.env.delete_sub_goal()
                return {"ok": True}
            if cmd == "state":
                return {"ok": True, "obs": _jsonable(self._last_obs)}
            if cmd == "close":
                return {"ok": True, "closed": True}
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}
        except Exception as e:                      # report, don't die
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def serve(bridge: Bridge, rfile, wfile) -> None:
    for line in rfile:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError as e:
            resp = {"ok": False, "error": f"bad json: {e}"}
        else:
            resp = bridge.handle(msg)
        wfile.write(json.dumps(resp) + "\n")
        wfile.flush()
        if resp.get("closed"):
            return


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default="UR5PlayAbsRPY1Obj-v0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the env (default: the card)")
    ap.add_argument("--port", type=int, default=None,
                    help="listen on TCP localhost:PORT instead of stdio")
    args = ap.parse_args(argv)

    bridge = Bridge(args.env, seed=args.seed, device=args.device)
    if args.port is None:
        serve(bridge, sys.stdin, sys.stdout)
        return
    import socket
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(1)
    print(f"[bridge] listening on 127.0.0.1:{args.port}", file=sys.stderr)
    conn, addr = srv.accept()
    with conn, conn.makefile("r") as rf, conn.makefile("w") as wf:
        serve(bridge, rf, wf)
    srv.close()


if __name__ == "__main__":
    main()

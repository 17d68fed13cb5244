"""PyTorch port: PlayEnv's camera on the CPU (render, obs["img"], the
sub-goal ghosts, the human PNG stream) and the tools around it,
tools/teleop_bridge_torch.py (tests/test_tools.py's round trips) and
tools/interactive_torch.py. UR5Reach-v0 has no objects, so no reset here
runs the 100-substep settle."""
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch.envs import wrapper
from roboticsplayroompybullet_torch.utils import render as rnd

import _torch_port as tp

sys.path.insert(0, os.path.join(tp.ROOT, "tools"))
torch.set_num_threads(1)
ENV = "UR5Reach-v0"


def _golden():
    with np.load(os.path.join(tp.ROOT, "tests", "golden",
                              ENV.replace("-", "_") + ".npz")) as z:
        return {k: z[k] for k in z.files}


def test_playenv_renders_on_its_device(tmp_path):
    """reset(o) → a step unrecorded (img None) → render("rgb_array") →
    a recorded step whose img is the new state's frame, the uint8 of the
    float frame → a sub-goal changes the frame, deleting it restores it
    → render("human") streams that frame as a PNG."""
    g = _golden()
    env = wrapper.make(ENV, seed=3, device="cpu")
    env.reset(o=g["o0"])
    obs, _, _, _ = env.step(g["actions"][0])
    assert obs["img"] is None
    m = env.model
    frame = env.render("rgb_array")
    assert frame.shape == (rnd.PIXELS, rnd.PIXELS, 3)
    assert frame.dtype == np.uint8

    env.human_render_path = str(tmp_path / "human.png")
    env.human_render_every = 1
    assert env.render("human").size == 0
    obs, _, _, _ = env.step(g["actions"][1])
    img = rnd.render_state(*m, env.state)[0].numpy()
    assert img.min() >= 0.0 and img.max() <= 1.0
    np.testing.assert_array_equal(obs["img"],
                                  (img * 255).astype(np.uint8))
    assert (obs["img"] != frame).any()          # the arm moved
    with open(env.human_render_path, "rb") as f:
        png = f.read()
    rnd.write_png(str(tmp_path / "want.png"), obs["img"])
    with open(tmp_path / "want.png", "rb") as f:
        assert png == f.read()

    ee = obs["controllable_achieved_goal"]
    env.visualise_sub_goal(ee + np.array([0.05, 0.0, 0.05, 0.0], np.float32),
                           "controllable_achieved_goal")
    ghosted = env.render("rgb_array")
    assert (ghosted != obs["img"]).any(-1).mean() > 0.01
    env.delete_sub_goal()
    np.testing.assert_array_equal(env.render("rgb_array"), obs["img"])


def test_teleop_bridge_round_trip():
    """Scripted client ↔ bridge: reset → step → goal injection → sub-goal
    → state-injection reset (tests/test_tools.py's round trip)."""
    import teleop_bridge_torch as tb

    b = tb.Bridge(ENV, seed=0, device="cpu")
    assert b.env.device.type == "cpu"
    r = b.handle({"cmd": "reset"})
    assert r["ok"] and "obs_quat" in r["obs"]
    obs0 = np.asarray(r["obs"]["obs_quat"], np.float32)

    r = b.handle({"cmd": "step", "action": [0.0] * 7})
    assert r["ok"] and isinstance(r["reward"], float)
    assert r["done"] is False
    assert "is_success" in r["info"] and "img" not in r["obs"]

    g = [0.05, 0.1, 0.05]
    r = b.handle({"cmd": "goal", "goal": g})
    assert r["ok"]
    np.testing.assert_allclose(r["goal"], g, atol=1e-6)

    cag = b._last_obs["controllable_achieved_goal"].tolist()
    assert b.handle({"cmd": "sub_goal", "sub_goal": cag,
                     "kind": "controllable_achieved_goal"})["ok"]
    assert b.env._sub_goal is not None
    assert b.handle({"cmd": "del_sub_goal"})["ok"]
    assert b.env._sub_goal is None

    # state injection: reset(o) restores from an obs vector
    r = b.handle({"cmd": "reset", "o": obs0.tolist()})
    assert r["ok"]
    np.testing.assert_allclose(
        np.asarray(r["obs"]["obs_quat"])[:3], obs0[:3], atol=5e-2)

    r = b.handle({"cmd": "state"})
    assert r["ok"] and r["obs"] is not None
    assert b.handle({"cmd": "nope"})["ok"] is False
    assert b.handle({"cmd": "step"})["ok"] is False      # no action
    assert b.handle({"cmd": "close"})["closed"] is True


def test_teleop_bridge_serve_loop():
    """serve(): newline-JSON in, newline-JSON out, exits on close."""
    import teleop_bridge_torch as tb

    b = tb.Bridge(ENV, seed=1, device="cpu")
    lines = [json.dumps({"cmd": "reset"}),
             json.dumps({"cmd": "step", "action": [0.0] * 7}),
             "not json",
             json.dumps({"cmd": "close"}),
             json.dumps({"cmd": "reset"})]     # after close: unreached
    out = io.StringIO()
    tb.serve(b, io.StringIO("\n".join(lines) + "\n"), out)
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resp) == 4                      # close stopped the loop
    assert resp[0]["ok"] and resp[1]["ok"]
    assert resp[2]["ok"] is False              # bad json reported
    assert resp[3]["closed"]


def test_interactive_repl(tmp_path, monkeypatch, capsys):
    """A scripted run of tools/interactive_torch.py: the goal, a
    joint teleport read from the state's row 0, a frame written as a PNG,
    the human stream toggled, an unknown command."""
    import interactive_torch as it

    cmds = iter(["goal", "j 0 0.1", "render", "human", "human", "nope",
                 "quit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(cmds))
    frame = str(tmp_path / "frame.png")
    it.main(["--env", ENV, "--device", "cpu", "--frame", frame])
    out = capsys.readouterr().out
    assert "goal: [" in out and "human-render ON" in out
    assert "human-render OFF" in out and "  ?" in out
    assert re.search(r"q\[:6\] = \[\s*0\.1\s", out), out
    with open(frame, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

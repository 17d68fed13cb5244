"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the program runs on the CPU (its
plain twin, which the reference agrees with bit for bit), at a small size,
once for each fault a cell can have. The cells are one card each, so no
exchange between cards can be left out."""
import time

import pytest
import torch

from portbench import harness

ROLLOUT = {"batch": 4, "horizon": 2, "input_sets": 2}
MPC = {"pop": 4, "horizon": 2, "iters": 2, "episode_steps": 4, "episodes": 2,
       "check_steps": 8}


def line(workload, overrides, seconds=0):
    args = harness.parse(["--workload", workload, "--seed", "3000000021",
                          "--seconds", str(seconds), "--trace", "0"])
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"),
                       overrides=overrides, require_card=False)


def rollout_fault(kind):
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    made = fs.make_reference_rollout

    def make(cfg, tree, arm, scene, horizon, **kw):
        roll = made(cfg, tree, arm, scene, horizon, **kw)
        ag_of = fs.make_lane_ag(cfg, tree, arm, kw.get("with_ee", False))

        def roll_B(X, actions):
            if kind == "unchanged":
                return X.clone(), torch.stack([ag_of(X)] * horizon)
            if kind == "half":
                h = X.shape[1] // 2
                Xf, ags = roll(X[:, :h], actions[..., :h])
                return (torch.cat([Xf, Xf], 1)[:, :X.shape[1]],
                        torch.cat([ags, ags], -1)[..., :X.shape[1]])
            Xf, ags = roll(X, actions)
            ags = ags.clone()
            ags[0, 0, 0] += 0.5                     # one answer altered
            return Xf, ags
        return roll_B
    return make


@pytest.mark.parametrize("workload", ["ur5play-rollout-b4096-h40",
                                      "pandaplay-rollout-b4096-h40"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_rollout_faults(monkeypatch, workload, kind):
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    monkeypatch.setattr(fs, "make_reference_rollout", rollout_fault(kind))
    got = line(workload, ROLLOUT)
    assert got["correct"] is False, got["checks"]


def test_rollout_sound():
    got = line("ur5play-rollout-b4096-h40", ROLLOUT)
    assert got["correct"] is True, got["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_mpc_faults(monkeypatch, kind):
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.solver import mpc
    if kind in ("unchanged", "altered"):
        made = fs.make_reference_step

        def make(*a, **kw):
            step = made(*a, **kw)

            def step_B(X, actions):
                if kind == "unchanged":
                    return X.clone()
                X2 = step(X, actions).clone()
                X2[0, 0] += 0.5                     # one answer altered
                return X2
            return step_B
        monkeypatch.setattr(fs, "make_reference_step", make)
    else:                               # the mean over half the population
        update = mpc._mppi_update

        def half(plan, cfg, actions, costs, group=None):
            n = costs.shape[-1] // 2
            return update(plan, cfg, actions[..., :n, :, :], costs[..., :n],
                          group)
        monkeypatch.setattr(mpc, "_mppi_update", half)
    got = line("ur5play-mpc-pop1024-h10", MPC, seconds=1)
    assert got["correct"] is False, got["checks"]


def test_mpc_sound():
    got = line("ur5play-mpc-pop1024-h10", MPC, seconds=1)
    assert got["correct"] is True, got["checks"]

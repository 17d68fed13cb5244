"""PyTorch port: the MPC task-competence eval (solver/eval.py) against the
JAX package's outputs (committed fixtures eval_*, written by
tools/gen_port_fixtures.py from the unchanged JAX package; no JAX runs
here).

Tolerances: family_goals bit for bit (the same numpy draws); the site
parameters atol 1e-7; the family costs rtol 1e-5 (float32 sums in another
order); pick's rest orientation atol 1e-6; the phase-A controller fed
JAX's ee and block per step: phases, counters and flags exactly, actions,
bias, hold pose and test-lift height atol 1e-6; one eval_family batch on
JAX's reset states and normals: rewards and success exactly, achieved
goals and states within tests/test_fused.py's 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.solver import eval as E
from roboticsplayroompybullet_torch.solver import mpc

import _torch_port as tp

torch.set_num_threads(1)
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"
PANDA_PLAY = "pandaPlayAbsRPY1Obj-v0"
PLAY_FAMILIES = ("block", "drawer", "door", "button", "dial")
T = torch.tensor


@pytest.fixture(scope="module")
def data():
    return tp.load("eval_data")


def _params(z, prefix):
    return {k[len(prefix):]: T(v) for k, v in z.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name,env_id", [
    ("UR5PlayAbsRPY1Obj", FLAGSHIP), ("pandaPlayAbsRPY1Obj", PANDA_PLAY),
    ("narrow", FLAGSHIP)])
def test_family_goals_match_jax(data, name, env_id):
    """The same reset achieved goals and seed give JAX's goals bit for bit:
    the block's resampling (and, where the object range lies within 0.10
    of every block, its last of 100 draws), the pinned button, the door's
    and dial's sides (ties included)."""
    cfg = CATALOG[env_id]
    if name == "narrow":
        cfg = dataclasses.replace(cfg, obj_lower_bound=(0.0, 0.1, 0.05),
                                  obj_upper_bound=(0.06, 0.16, 0.1))
    ags = data[f"goals_{name}_ags"]
    for fam in PLAY_FAMILIES if name != "narrow" else ("block",):
        got = E.family_goals(cfg, ags, fam, np.random.default_rng(41))
        np.testing.assert_array_equal(got, data[f"goals_{name}_{fam}"],
                                      err_msg=fam)
    with pytest.raises(ValueError):
        E.family_goals(cfg, ags, "pick", np.random.default_rng(0))


@pytest.mark.parametrize("env_id", [FLAGSHIP, PANDA_PLAY])
def test_family_site_params_match_jax(data, env_id):
    m = core.build_model(CATALOG[env_id])
    for fam in PLAY_FAMILIES:
        got = E.family_site_params(m, fam, reach_w=0.7)
        want = {k.split("_", 3)[3]: v for k, v in data.items()
                if k.startswith(f"site_{tp.key(env_id)}_{fam}_")}
        assert got.keys() == want.keys(), fam
        for k, v in got.items():
            assert np.asarray(v).dtype == np.float32, (fam, k)
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-7,
                                       err_msg=f"{fam} {k}")


@pytest.mark.parametrize("case", [0, 1, 2])
def test_play_cost_matches_jax(data, case):
    """make_play_cost over (2 envs, 8 candidates, H=3), a different family
    per env (case 0: block with push_w 0.05) against JAX's cost vmapped
    over env and candidate."""
    m = core.build_model(CATALOG[FLAGSHIP])
    c = f"play{case}"
    cost = E.make_play_cost(m)(T(data[f"{c}_ags"]),
                               T(data[f"{c}_goal"])[:, None],
                               T(data[f"{c}_acts"]),
                               _params(data, f"{c}_p_"))
    assert cost.shape == data[f"{c}_cost"].shape
    np.testing.assert_allclose(cost.numpy(), data[f"{c}_cost"], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("case", [0, 1])
def test_pick_cost_matches_jax(data, case):
    """make_pick_cost with candidates on both sides of `near` (the EE
    within 0-2 near of the grasp point), the acquisition and carry
    parameters, open_w and goal_w."""
    m = core.build_model(CATALOG["pandaPick-v0"])
    c = f"pick{case}"
    p = _params(data, f"{c}_p_")
    ags = T(data[f"{c}_ags"])
    d = torch.linalg.vector_norm(
        ags[..., 3:] - ags[..., :3] - T([0.0, 0.0, 1.0])
        * p["grasp_z"][:, None, None, None], dim=-1)
    near = d < p["near"][:, None, None]
    assert bool(near.any()) and not bool(near.all())
    cost = E.make_pick_cost(m)(ags, T(data[f"{c}_goal"])[:, None],
                               T(data[f"{c}_acts"]), p)
    np.testing.assert_allclose(cost.numpy(), data[f"{c}_cost"], rtol=1e-5,
                               atol=0)


def test_success_matches_jax(data):
    play = E._success(CATALOG[FLAGSHIP], "block", data["succ_play_rs"],
                      None, None)
    np.testing.assert_array_equal(play, data["succ_play"])
    reach = E._success(CATALOG["UR5Reach-v0"], "reach", None,
                       data["succ_reach_ags"], data["succ_reach_goals"])
    np.testing.assert_array_equal(reach, data["succ_reach"])
    assert data["succ_play"].any() and not data["succ_play"].all()
    assert data["succ_reach"].any() and not data["succ_reach"].all()


def test_stack_params_broadcasts_over_envs():
    p = E._stack_params(E.pick_params(), 3, "cpu")
    assert p["goal_w"].shape == (3, 3) and p["near"].shape == (3,)
    assert p["goal_w"].dtype == torch.float32
    np.testing.assert_array_equal(p["goal_w"][2].numpy(), [1.0, 1.0, 2.0])


def test_rest_orientation_matches_jax(data):
    m = core.build_model(CATALOG["pandaPick-v0"])
    np.testing.assert_allclose(E.rest_orientation(m), data["rpy0_pandaPick"],
                               rtol=0, atol=1e-6)


def test_acquire_controller_matches_jax(data):
    """eval_pick's phase A teacher-forced: fed the ee and block positions
    JAX's controller read at each step (pandaPick, 4 envs, budget 70, a
    seed whose run visits every phase and a retry), _acquire_step gives
    JAX's actions, phases and controller variables at every step, and the
    loop stops where JAX's did."""
    z = tp.load("eval_pick_acquire")
    steps = z["t"].shape[0]
    phases = set(z["phase"].ravel().tolist())
    assert phases == set(range(6)) and z["retried"][-1].any()
    assert int(z["acquire_budget"]) == E.ACQUIRE_BUDGET
    assert steps == int(z["acquire_budget"]) or (z["phase"][-1] == 5).all()
    n = int(z["n_envs"])
    ctrl = E.acquire_init(n, "cpu")
    rpy0 = T(data["rpy0_pandaPick"])
    for i in range(steps):
        assert int(z["t"][i]) == i
        assert bool((ctrl.phase < 5).any())          # the loop went on
        a, ctrl = E._acquire_step(ctrl, T(z["ee"][i]), T(z["blk"][i]), i,
                                  rpy0)
        msg = f"step {i}"
        np.testing.assert_allclose(a.numpy(), z["a"][i], rtol=0, atol=1e-6,
                                   err_msg=msg)
        for f in ("phase", "close_ctr", "lift_ctr", "retried"):
            np.testing.assert_array_equal(getattr(ctrl, f).numpy(),
                                          z[f][i], err_msg=f"{msg} {f}")
        for f in ("z_at_test", "hold_pos", "bias"):
            np.testing.assert_allclose(getattr(ctrl, f).numpy(), z[f][i],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{msg} {f}")


def test_eval_family_batch_matches_jax(monkeypatch):
    """One eval_family batch on the plain twin (the flagship's block
    family, 2 envs x 64 candidates, H=2, 1 iteration, 1 substep, 3 steps)
    on JAX's reset states and normals: the family goals, each step's
    rewards and achieved goals, the final states and the success stats
    equal JAX's."""
    z = tp.load(f"eval_family_{tp.key(FLAGSHIP)}")
    m = core.build_model(CATALOG[FLAGSHIP])
    n = int(z["n_envs"])
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]), pop=int(z["pop"]),
                        iters=int(z["iters"]), algorithm="mppi",
                        sigma_init=0.3)
    reset = interop.state_from_numpy(
        {k[3:]: v for k, v in z.items() if k.startswith("in_")}, "cpu")
    normals = iter(T(z["normals"]).flatten(0, 1))
    monkeypatch.setattr(mpc, "_normals", lambda gen, shape, device:
                        next(normals).reshape(shape))
    monkeypatch.setattr(E, "batched_reset", lambda m_, gen, b, device:
                        (reset, {}))
    calls, made = [], E.make_batched_fused_mpc_step

    def recording(*a, **k):
        f = made(*a, **k)

        def step(states, plans, gen, params):
            calls.append((states, plans, f(states, plans, gen, params)))
            return calls[-1][2]
        return step

    monkeypatch.setattr(E, "make_batched_fused_mpc_step", recording)
    res = E.eval_family(m, cfg, str(z["family"]), n_episodes=n, n_envs=n,
                        n_steps=int(z["n_steps"]), seed=int(z["seed"]),
                        n_substeps=int(z["n_substeps"]), device="cpu")
    assert next(normals, None) is None            # one draw per iteration
    st0, pl0 = calls[0][0], calls[0][1]
    np.testing.assert_allclose(st0.goal.numpy(), z["in_goal"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pl0.mean.numpy(), z["plan_mean"], rtol=0,
                               atol=1e-4)
    rs = np.stack([c[2][2].numpy() for c in calls])
    ags = np.stack([c[2][3].numpy() for c in calls])
    np.testing.assert_array_equal(rs, z["rewards"])
    np.testing.assert_allclose(ags, z["ags"], rtol=0, atol=1e-4)
    fin = calls[-1][2][0]
    for f in ("q", "qd", "obj_pos", "obj_quat", "art_q", "art_qd"):
        np.testing.assert_allclose(getattr(fin, f).numpy(), z[f"out_{f}"],
                                   rtol=0, atol=1e-4, err_msg=f)
    assert res["n_success"] == int(z["n_success"])
    assert res["success_rate"] == pytest.approx(float(z["success_rate"]))
    assert res["n_episodes"] == n and res["n_steps"] == int(z["n_steps"])

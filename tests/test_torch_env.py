"""PyTorch port: the env layer (envs/obs.py, envs/core.py, envs/wrapper.py,
gym_registry.py, parallel/rollout.py and solver/mpc.py's plan /
mpc_rollout) against the JAX package's outputs, from committed fixtures
(tools/gen_port_fixtures.py: golden_lane_*, proprio, settle_*,
mpc_plan_loop_*); no JAX program runs here.

Tolerances: calc_obs atol 1e-5 per key (the lane FK against the JAX
oracle's FK), gripper_proprioception exactly; reset(o=golden o0) object
poses and goal 1e-6, q at the control bounds of tests/test_fused.py (p99 ≤
1e-3, max ≤ 0.1: the lane IK's unrolled Cholesky against the JAX LU solve
can flip a fixed point); PlayEnv's first two steps of a golden within
tests/test_golden.py's bounds and, per packed field, within 1e-4 of the
JAX lane twin's replay (tests/test_fused.py:54); the MPC loop at
test_torch_mpc.py::test_closed_loop_matches_jax's bounds.

No test here runs the 100-substep settle or more than two control steps of
a golden (each costs seconds on a CPU); the card runs those
(chip_smoke.py).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch import gym_registry, interop
from roboticsplayroompybullet_torch.envs import core, wrapper
from roboticsplayroompybullet_torch.envs import obs as O
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs
from roboticsplayroompybullet_torch.parallel import rollout as R
from roboticsplayroompybullet_torch.solver import mpc

import _torch_port as tp

torch.set_num_threads(1)
T = torch.tensor
IDS = sorted(CATALOG)
SMOKE = ("UR5Reach-v0", "pandaPick-v0", "UR5PlayAbsRPY1Obj-v0")
OBS_KEYS = ("obs_quat", "achieved_goal", "desired_goal",
            "controllable_achieved_goal", "full_positional_state", "joints",
            "velocity", "observation")


def _state(z, prefix):
    return interop.state_from_numpy(
        {k[len(prefix):]: v[None] for k, v in z.items()
         if k.startswith(prefix)}, "cpu")


def _assert_obs(o, z, prefix):
    for k in OBS_KEYS:
        np.testing.assert_allclose(o[k].numpy()[0], z[f"{prefix}_{k}"],
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(o["gripper_proprioception"].numpy()[0],
                                  z[f"{prefix}_gripper_proprioception"])


def _inject_goal_draws(monkeypatch, z):
    """core's draws replaced by the ones jax.random made for reset_goal."""
    monkeypatch.setattr(core, "_uniform", lambda gen, shape, device: T(
        z["goal_u"], dtype=torch.float32).reshape(shape))
    monkeypatch.setattr(core, "_randint", lambda gen, high, shape, device: T(
        z["goal_idx"], dtype=torch.int64).reshape(shape))


def _assert_control_bounds(a, b, what):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 0.1, (what, d.max())


@pytest.mark.parametrize("env_id", IDS)
def test_calc_obs_matches_jax(env_id):
    """calc_obs on the JAX lane replay's first-step state, and on that
    state with negated continuity buffers (play envs: _flip_quats fires on
    every quaternion pair)."""
    z = tp.load(f"golden_lane_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    st = _state(z, "st1_")
    o = O.calc_obs(*m, st)
    _assert_obs(o, z, "obs1")
    flip = O.calc_obs(*m, st.replace(prev_obs=-o["obs_quat"],
                                     prev_ag=-o["achieved_goal"]))
    _assert_obs(flip, z, "flip")
    if m.cfg.play:
        assert (np.sign(flip["obs_quat"].numpy()[0, 3:7])
                == -np.sign(o["obs_quat"].numpy()[0, 3:7])).all()


@pytest.mark.parametrize("name,case,want", [
    ("ur5", "on_ray", 1.0), ("ur5", "far", 0.0), ("panda", "rest", -1.0)])
def test_proprioception_cases(name, case, want):
    """tests/test_proprioception.py's cases on fixture states: a block on
    the ray segment but off the inter-pad midpoint trips it, an empty
    gripper reads 0, the Panda reads −1."""
    z = tp.load("proprio")
    env_id = ("UR5PlayAbsRPY1Obj-v0" if name == "ur5"
              else "pandaPlayAbsRPY1Obj-v0")
    m = core.build_model(CATALOG[env_id])
    o = O.calc_obs(*m, _state(z, f"{name}_{case}_"))
    assert float(o["gripper_proprioception"][0]) == want
    assert float(z[f"{name}_{case}_prop"]) == want


@pytest.mark.parametrize("env_id", IDS)
def test_reset_with_state_injection_matches_jax(env_id, monkeypatch):
    """reset(o=golden o0) on JAX's goal draws: objects and goal at 1e-6, q
    at the control bounds, the obs dict as calc_obs's test holds it."""
    z = tp.load(f"golden_lane_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    _inject_goal_draws(monkeypatch, z)
    with torch.no_grad():
        st, obs = core.reset(m, None, 1, o=z["o0"], device="cpu")
    for f in ("obj_pos", "obj_quat", "obj_vel", "art_q", "goal"):
        np.testing.assert_allclose(getattr(st, f).numpy()[0],
                                   z[f"reset_{f}"], rtol=0, atol=1e-6,
                                   err_msg=f)
    _assert_control_bounds(st.q.numpy()[0], z["reset_q"], "q")
    assert bool(st.has_prev[0]) and int(st.t[0]) == 0
    _assert_obs(obs, z, "reset")
    assert "_prev_obs" not in obs


@pytest.mark.parametrize("env_id", SMOKE)
def test_playenv_replays_golden_start(env_id):
    """PlayEnv(device="cpu"): reset(o=o0), then the golden's first two
    actions, within tests/test_golden.py's bounds of the golden and within
    the one-step bounds of the JAX lane twin's replay."""
    lane = tp.load(f"golden_lane_{tp.key(env_id)}")
    with np.load(os.path.join(tp.ROOT, "tests", "golden",
                              env_id.replace("-", "_") + ".npz")) as z:
        g = {k: z[k] for k in z.files}
    env = wrapper.make(env_id, seed=7, device="cpu")
    env.reset(o=g["o0"])
    m = env.model
    for t in range(2):
        obs, r, done, info = env.step(g["actions"][t])
        assert not done and obs["img"] is None
        assert np.linalg.norm(obs["controllable_achieved_goal"][:3]
                              - g["ee"][t]) < 2e-3
        assert np.abs(obs["achieved_goal"] - g["ag"][t]).max() < 5e-3
        assert np.abs(env.state.q.numpy()[0] - g["q"][t]).max() < 2e-2
        X = fs.pack_state(m.cfg, m.tree, env.state)[:, 0].numpy()
        for name, sl in tp.field_slices(m.cfg, m.tree):
            np.testing.assert_allclose(X[sl], lane["X"][t][sl], rtol=0,
                                       atol=1e-4, err_msg=f"{name} t={t}")
        assert int(env.state.t[0]) == t + 1
        assert info["is_success"] == float(r >= 0)
        np.testing.assert_array_equal(info["target_poses"],
                                      env.state.ctrl_q.numpy()[0])


def test_random_reset_on_reach():
    """A random reset of 8 UR5Reach envs (no objects, so no settle): none
    solved, goals in their range, the ee near its IK target, and the same
    result from the same generator seed."""
    m = core.build_model(CATALOG["UR5Reach-v0"])
    cfg = m.cfg
    out = []
    for _ in range(2):
        stats = {}
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            st, obs = R.batched_reset(m, gen, 8, device="cpu", stats=stats)
        out.append((st, obs, stats))
    (st, obs, stats), (st2, obs2, _) = out
    for f in ("q", "goal", "prev_obs"):
        assert torch.equal(getattr(st, f), getattr(st2, f)), f
    r = core.compute_reward(cfg, obs["achieved_goal"], obs["desired_goal"])
    assert (r == -1.0).all()
    lo, hi = T(cfg.goal_range_low), T(cfg.goal_range_high)
    assert ((st.goal >= lo) & (st.goal <= hi)).all()
    # the arm's IK target is the generator's first draw (+0.2 m in z)
    u = torch.rand((8, 3), generator=torch.Generator().manual_seed(3))
    target = lo + u * (hi - lo) + T([0.0, 0.0, 0.2])
    assert (obs["controllable_achieved_goal"][:, :3] - target).norm(
        dim=-1).max() < 0.02
    assert (stats["resets"] >= 1).all() and (stats["placements"] == 0).all()


def test_objects_oob_checks_the_upper_bound_only():
    m = core.build_model(CATALOG["pandaPush-v0"])
    st = core._default_state(m, 3, "cpu")
    hi = T(m.cfg.env_range_high)
    pos = torch.stack([hi - 0.01, hi - 1.0, hi + T([0.0, 0.0, 1e-3])])
    st = st.replace(obj_pos=pos[:, None])
    assert core._objects_oob(m.cfg, st).tolist() == [False, False, True]


def test_re_place_loop_redraws_only_the_envs_out_of_bounds(monkeypatch):
    """The re-place loop with the settle replaced by a scripted placement:
    each attempt places only the envs still out of bounds, in-bounds envs
    keep their draw, and an env that never lands in bounds stops at the
    cap of 20 placements."""
    m = core.build_model(CATALOG["pandaPush-v0"])
    hi = T(m.cfg.env_range_high)
    # env e lands in bounds at its placement k_e (0-based); env 3 never
    lands = T([0, 2, 1, 99])
    calls = []

    def place(m_, st, gen):
        # rng[:, 0] tags the env, t counts its placements (neither is
        # touched by the loop)
        B = st.q.shape[0]
        calls.append(B)
        inb = st.t.long() >= lands[st.rng[:, 0]]
        pos = (hi - 0.05).repeat(B, 1)
        pos[:, 0] += torch.where(inb, 0.0, 0.1)
        return st.replace(obj_pos=pos[:, None], t=st.t + 1)

    monkeypatch.setattr(core, "_place_and_settle", place)
    st = core._default_state(m, 4, "cpu")
    st = st.replace(rng=torch.arange(4)[:, None].repeat(1, 2))
    count = torch.zeros(4, dtype=torch.int64)
    out = core._reset_objects(m, st, None, None, count)
    assert count.tolist() == [1, 3, 2, 20]
    assert out.t.tolist() == count.tolist()
    assert out.rng[:, 0].tolist() == [0, 1, 2, 3]
    assert calls[:3] == [4, 3, 2] and calls[3:] == [1] * 17
    assert out.obj_pos[:3, 0, 0].le(hi[0]).all()
    assert out.obj_pos[3, 0, 0] > hi[0]         # the cap keeps the last draw


@pytest.mark.parametrize("env_id", ("UR5PlayAbsRPY1Obj-v0", "pandaPlay-v0"))
def test_placement_replays_jax_draws(env_id, monkeypatch):
    """_place_and_settle on the settle fixture's U(0, 1) draws (the settle
    itself replaced by the identity: the card holds the settle against
    JAX's, chip_smoke.py::settle_vs_jax) places every block where JAX's
    _place_and_settle did: scaled to the object bounds, staggered 3 cm a
    block, turned 90° about z, at rest."""
    z = tp.load(f"settle_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    u = T(z["u"][:16])
    monkeypatch.setattr(core, "_uniform", lambda gen, shape, dev:
                        u.reshape(shape))
    monkeypatch.setattr(core, "_settler", lambda m_: lambda X, c, g: X)
    st = core._default_state(m, 16, "cpu")
    st = st.replace(obj_vel=torch.ones_like(st.obj_vel))
    out = core._place_and_settle(m, st, None)
    np.testing.assert_allclose(out.obj_pos.numpy(), z["placed"][:16],
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        out.obj_quat.numpy(),
        np.broadcast_to(np.float32([0.0, 0.0, 0.7071, 0.7071]),
                        out.obj_quat.shape))
    assert not out.obj_vel.any() and not out.obj_angvel.any()


@pytest.mark.parametrize("env_id", IDS)
def test_observation_spaces_match_jax(env_id):
    from roboticsplayroompybullet_tpu.envs import wrapper as jw
    from roboticsplayroompybullet_tpu.envs.config import CATALOG as JC
    ours = wrapper._observation_spaces(CATALOG[env_id])
    ref = jw._observation_spaces(JC[env_id])
    assert set(ours.spaces) == set(ref.spaces)
    for k, box in ref.spaces.items():
        np.testing.assert_array_equal(ours[k].low, box.low, err_msg=k)
        np.testing.assert_array_equal(ours[k].high, box.high, err_msg=k)
    env = wrapper.PlayEnv(CATALOG[env_id], device="cpu")
    np.testing.assert_array_equal(env.action_space.high,
                                  np.asarray(JC[env_id].action_high,
                                             np.float32))


class _FakeReg:
    """Minimal gym-like registration surface (tests/test_gym_shim.py)."""

    def __init__(self):
        self.specs = {}

        class _Envs:
            pass

        self.envs = _Envs()
        self.envs.registry = self.specs

    def register(self, id, entry_point, **kw):
        self.specs[id] = {"entry_point": entry_point, **kw}


def test_register_against_fake_registry():
    fake = _FakeReg()
    assert gym_registry.register_gym_envs(module=fake)
    assert set(fake.specs) == set(CATALOG)
    assert fake.specs["UR5PlayAbsRPY1Obj-v0"]["max_episode_steps"] is None
    assert fake.specs["pandaReach-v0"]["max_episode_steps"] == 250
    env = fake.specs["UR5Reach-v0"]["entry_point"](device="cpu")
    assert isinstance(env, wrapper.PlayEnv) and env.device.type == "cpu"
    assert gym_registry.register_gym_envs(module=fake)


def test_envs_live_on_the_card_unless_asked():
    """PlayEnv, BatchedEnv and make put their state on the card by
    default; the CPU only when asked. Here, with no CUDA build of torch,
    the default reset raises instead of falling back."""
    cfg = CATALOG["UR5Reach-v0"]
    envs = [wrapper.PlayEnv(cfg), wrapper.BatchedEnv(cfg, 2),
            wrapper.make("UR5Reach-v0"), wrapper.make("UR5Reach-v0", 2)]
    assert all(e.device.type == "cuda" for e in envs)
    for e in envs:
        if torch.cuda.is_available():
            e.reset()
            assert e.state.q.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                e.reset()
    cpu = wrapper.BatchedEnv(cfg, 2, device="cpu")
    with torch.no_grad():
        obs = cpu.reset()
    assert cpu.state.q.device.type == "cpu"
    assert obs["observation"].shape == (2, 6)   # quat slot → Euler
    fresh = wrapper.PlayEnv(cfg, device="cpu")
    assert fresh.render("rgb_array") is None    # recording on, no state yet
    assert fresh.render("human").size == 0
    with pytest.raises(NotImplementedError):
        wrapper.PlayEnv(cfg, device="cpu").vr_activation()


@pytest.mark.parametrize("algo", ["mppi", "cem"])
def test_mpc_rollout_matches_jax(algo, monkeypatch):
    """mpc_rollout (plan scored at full fidelity, the executed step by
    step_physics_only) from init_plan's zero mean on UR5Reach (1 substep,
    8 candidates, H=2, 2 iterations, 2 steps) against JAX's mpc_rollout on
    JAX's normals."""
    z = tp.load("mpc_plan_loop_UR5Reach")
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=int(z["n_substeps"])))
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]), pop=int(z["pop"]),
                        iters=int(z["iters"]), algorithm=algo)
    normals = iter(T(z["normals"]).flatten(0, 1))
    monkeypatch.setattr(mpc, "_normals", lambda gen, shape, device:
                        next(normals).reshape(shape))
    st = _state(z, "in_")
    with torch.no_grad():
        fin, acts, rs, bests = mpc.mpc_rollout(m, cfg, st, torch.Generator(),
                                               int(z["n_steps"]))
    assert next(normals, None) is None            # one draw per iteration
    d = np.abs(acts.numpy() - z[f"{algo}_actions"])
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 5e-2, d.max()
    for f in ("q", "qd", "art_q", "art_qd"):
        np.testing.assert_allclose(getattr(fin, f).numpy()[0],
                                   z[f"{algo}_out_{f}"], rtol=0, atol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(fin.t.numpy()[0], z[f"{algo}_out_t"])
    np.testing.assert_array_equal(rs.numpy(), z[f"{algo}_rewards"])
    np.testing.assert_allclose(bests.numpy(), z[f"{algo}_bests"], rtol=1e-4)


def test_control_returns_the_lane_control():
    """core.control on an EnvState: the lane control's servo targets (at
    the control bounds of JAX's, tests/test_fused.py:97-100) and grip."""
    env_id = "UR5PlayRelRPY1Obj-v0"
    z = tp.load(f"control_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    st = tp.zero_state(m.cfg, m.tree, z["q"].shape[1]).replace(
        q=T(z["q"].T.copy()))
    with torch.no_grad():
        targets, grip = core.control(m, st, T(z["actions"].T.copy()))
    _assert_control_bounds(targets.numpy().T, z["targets"], "targets")
    np.testing.assert_allclose(grip.numpy(), z["grip"], rtol=0, atol=1e-6)


def test_batched_rollout_matches_jax():
    """parallel.rollout: batched_rollout (one rollout launch on the card)
    and the one-env rollout on 4 UR5Reach envs of the reach rollout
    fixture (H=2, 3 substeps), against JAX's ags and rewards; then
    success_rate."""
    z = tp.load("rollout_UR5Reach")
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=int(z["n_substeps"])))
    st = interop.state_from_numpy(
        {k[3:]: v[:4] for k, v in z.items() if k.startswith("in_")}, "cpu")
    acts = T(z["actions"][:4])
    with torch.no_grad():
        fin, rs, ags = R.batched_rollout(m, st, acts)
        one = R.rollout(m, core._take(st, torch.arange(1)), acts[0])
    np.testing.assert_allclose(ags.numpy(), z["ags"][:4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rs.numpy(), z["rewards"][:4], rtol=0,
                               atol=1e-4)     # −distance where within reach
    assert torch.equal(one[2], ags[0]) and torch.equal(one[1], rs[0])
    assert (fin.t == st.t + 2).all()
    want = float((z["rewards"][:4, -1] >= 0).mean())
    assert float(R.success_rate(rs[:, -1])) == want

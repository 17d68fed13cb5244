"""PyTorch port: the MPC solver (solver/cost.py, solver/mpc.py,
envs/obs.py) against the JAX package's outputs (committed fixtures written
by tools/gen_port_fixtures.py; no JAX runs here).

Tolerances: costs and the MPPI/CEM updates atol 1e-5 (float32 sums in
another order); the AR(1)/clip transform 1e-6 (the same float32 ops); the
ee hold of init_plan_from_state 1e-4 (the lane FK against the JAX oracle's
FK); the whole batched MPC step: states within tests/test_fused.py's 1e-4,
plan means p99 <= 1e-3 and max <= 5e-2 (an IK fixed point that flips in one
candidate moves its cost, and the MPPI weights with it); the closed loop
likewise for its actions and final state, its best costs rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core, obs
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.envs.state import EnvState
from roboticsplayroompybullet_torch.ops import fused_step as fs
from roboticsplayroompybullet_torch.solver import cost, mpc

import _torch_port as tp

torch.set_num_threads(1)
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"
T = torch.tensor


@pytest.mark.parametrize("name,env_id,orn", [
    ("play1", FLAGSHIP, None), ("play2", "pandaPlay-v0", None),
    ("obj", "pandaPick-v0", None), ("obj_orn", "pandaPick-v0", True),
    ("reach", "UR5Reach-v0", None)])
def test_cost_matches_jax(name, env_id, orn):
    """goal_distance per step and trajectory_cost over a batch of rollouts,
    a third of them with block quats equal to the goal's (arccos clip)."""
    z = tp.load("mpc_cost")
    cfg = CATALOG[env_id]
    if orn is not None:
        cfg = dataclasses.replace(cfg, use_orientation=orn)
    ag, g, acts = (T(z[f"{name}_{k}"]) for k in ("ag", "goal", "acts"))
    d = cost.goal_distance(cfg, ag, g[:, None])
    np.testing.assert_allclose(d.numpy(), z[f"{name}_dist"], rtol=0,
                               atol=1e-5)
    c = cost.trajectory_cost(cfg, ag, g, acts)
    assert c.shape == (ag.shape[0],)
    np.testing.assert_allclose(c.numpy(), z[f"{name}_cost"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("env_id", [
    FLAGSHIP,                    # absolute_rpy: ee pos + Euler of ee quat
    "UR5Reach-v0",               # absolute_rpy, no objects
    "pandaPlay1Obj-v0",          # absolute_quat with orientation
    "UR5PlayAbsJoints1Obj-v0",   # absolute_joints: the arm's q
    "UR5PlayRelRPY1Obj-v0"])     # relative: zeros
def test_init_plan_from_state_matches_jax(env_id):
    z = tp.load("mpc_init")
    m = core.build_model(CATALOG[env_id])
    k = tp.key(env_id)
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]))
    q = T(z[f"{k}_q"])
    st = tp.zero_state(m.cfg, m.tree, q.shape[0]).replace(
        q=q, qd=T(z[f"{k}_qd"]))
    pl = mpc.init_batched_plan(m, cfg, 8, st)
    np.testing.assert_allclose(pl.mean.numpy(), z[f"{k}_mean"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(pl.sigma.numpy(), z[f"{k}_sigma"])


def test_sample_transform_matches_jax():
    """_sample's AR(1) noise, candidate 0 and clip, on jax.random's normals."""
    z = tp.load("mpc_sample")
    cfg = mpc.MPCConfig(smooth=float(z["smooth"]))
    pl = mpc.PlanState(T(z["mean"]), T(z["sigma"]))
    acts = mpc._sample_from(pl, cfg, T(z["noise"]), T(z["high"]))
    np.testing.assert_allclose(acts.numpy(), z["actions"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("env_id", [FLAGSHIP, "pandaPlay1Obj-v0",
                                    "UR5PlayRelJoints1Obj-v0"])
@settings(max_examples=20, deadline=None, database=None)
@given(seed=hst.integers(0, 2 ** 31 - 1), n=hst.integers(1, 9),
       scale=hst.floats(0.0, 4.0))
def test_sampled_actions_lie_within_bounds(env_id, seed, n, scale):
    """Every sampled action lies within ±action_high and candidate 0 of
    every env equals its mean, for means anywhere inside the bounds and any
    sigma."""
    high = T(CATALOG[env_id].action_high, dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    E, H = 2, 3
    mean = (torch.rand(E, H, len(high), generator=g) * 2 - 1) * high
    sigma = torch.rand(E, H, len(high), generator=g) * scale * high
    acts = mpc._sample(g, mpc.PlanState(mean, sigma), mpc.MPCConfig(), n,
                       high)
    assert acts.shape == (E, n, H, len(high))
    assert bool((acts.abs() <= high).all())
    assert torch.equal(acts[:, 0], mean)


@pytest.mark.parametrize("algorithm", ["mppi", "cem"])
def test_updates_match_jax(algorithm):
    """Two envs' updates in one call; CEM's k-th cost has ties (all of
    them enter the elite, as JAX's costs <= thresh)."""
    z = tp.load("mpc_update")
    cfg = mpc.MPCConfig(pop=int(z["pop"]), elite_frac=float(z["elite_frac"]),
                        algorithm=algorithm)
    update = mpc._update_fn(cfg)
    pl, best = update(mpc.PlanState(T(z["mean"]), T(z["sigma"])), cfg,
                      T(z["actions"]), T(z["costs"]))
    np.testing.assert_array_equal(best.numpy(), z["costs"].min(-1))
    for f in ("mean", "sigma"):
        np.testing.assert_allclose(getattr(pl, f).numpy(),
                                   z[f"{algorithm}_{f}"], rtol=0, atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("env_id", [FLAGSHIP, "UR5Reach-v0", "pandaPick-v0",
                                    "pandaPlay-v0"])
def test_achieved_goal_equals_the_lane_ag(env_id):
    """obs.achieved_goal on an EnvState == fs.make_lane_ag on its packed
    rows (the kernels' ag), on the sim fixtures' states."""
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    X = T(z["X"])
    st = fs.unpack_state(m.cfg, m.tree, X,
                         tp.zero_state(m.cfg, m.tree, X.shape[1]))
    ag = obs.achieved_goal(m.cfg, m.tree, m.arm, st)
    assert ag.shape == (X.shape[1], m.cfg.ag_dim)
    np.testing.assert_array_equal(
        ag.numpy(), fs.make_lane_ag(m.cfg, m.tree, m.arm)(X).T.numpy())


def test_batched_mpc_step_matches_jax(monkeypatch):
    """make_batched_fused_mpc_step on the plain twin (2 envs x 64
    candidates, H=2, 2 MPPI iterations, 1 substep, with_ee and a cost_fn
    reading cost_params) against JAX's, on JAX's normals."""
    z = tp.load(f"mpc_step_{tp.key(FLAGSHIP)}")
    m = core.build_model(CATALOG[FLAGSHIP])
    E = int(z["n_envs"])
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]), pop=int(z["pop"]),
                        iters=int(z["iters"]), algorithm="mppi",
                        sigma_init=float(z["sigma_init"]))
    normals = iter(T(z["normals"]))
    monkeypatch.setattr(mpc, "_normals", lambda gen, shape, device:
                        next(normals).reshape(shape))
    st = interop.state_from_numpy(
        {k[3:]: v for k, v in z.items() if k.startswith("in_")}, "cpu")
    step = mpc.make_batched_fused_mpc_step(
        m, cfg, E, n_substeps=int(z["n_substeps"]), with_ee=True,
        cost_fn=tp.mpc_step_cost(m.cfg, cfg.weights))
    plans = mpc.PlanState(T(z["plan_mean"]), T(z["plan_sigma"]))
    with torch.no_grad():
        st2, pl2, rs, ags = step(st, plans, torch.Generator(),
                                 {"reach": T(z["reach"])})
    assert next(normals, None) is None            # one draw per iteration
    d = np.abs(pl2.mean.numpy() - z["out_mean"])
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 5e-2, d.max()
    np.testing.assert_array_equal(pl2.sigma.numpy(), z["out_sigma"])
    for f in ("q", "qd", "obj_pos", "obj_quat", "obj_vel", "obj_angvel",
              "art_q", "art_qd"):
        np.testing.assert_allclose(getattr(st2, f).numpy(), z[f"out_{f}"],
                                   rtol=0, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(st2.t.numpy(), z["out_t"])
    np.testing.assert_allclose(ags.numpy(), z["ags"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rs.numpy(), z["rewards"])


@pytest.mark.parametrize("algo", ["mppi", "cem"])
def test_closed_loop_matches_jax(algo, monkeypatch):
    """make_fused_mpc_rollout on the plain twin from init_plan's zero mean
    (UR5Reach, 1 substep, 128 candidates, H=2, 2 iterations, 2 steps)
    against JAX's loop on JAX's normals: the port's closed loop is JAX's
    function of the draws."""
    z = tp.load("mpc_loop_UR5Reach")
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=int(z["n_substeps"])))
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]), pop=int(z["pop"]),
                        iters=int(z["iters"]), algorithm=algo)
    normals = iter(T(z["normals"]).flatten(0, 1))
    monkeypatch.setattr(mpc, "_normals", lambda gen, shape, device:
                        next(normals).reshape(shape))
    st = interop.state_from_numpy(
        {k[3:]: v[None] for k, v in z.items() if k.startswith("in_")}, "cpu")
    with torch.no_grad():
        fin, acts, rs, bests = mpc.make_fused_mpc_rollout(
            m, cfg, int(z["n_steps"]))(st, torch.Generator())
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


def test_planner_and_closed_loop_run_on_the_twin():
    """make_fused_planner and make_fused_mpc_rollout on CPU tensors (the
    plain twin) at a tiny size: shapes, bounds, t, and the warm-start
    candidate bounding the best cost."""
    m = core.build_model(dataclasses.replace(CATALOG["UR5Reach-v0"],
                                             substeps=1))
    z = tp.load("rollout_UR5Reach")
    st = interop.state_from_numpy(
        {k[3:]: v[:1] for k, v in z.items() if k.startswith("in_")}, "cpu")
    cfg = mpc.MPCConfig(horizon=2, pop=5, iters=1, preview_ik_iters=2)
    high = T(m.cfg.action_high, dtype=torch.float32)
    with torch.no_grad():
        plan0 = mpc.init_batched_plan(m, cfg, 1, st)
        pl, best = mpc.make_fused_planner(m, cfg)(
            st, mpc.PlanState(plan0.mean[0], plan0.sigma[0]),
            torch.Generator().manual_seed(0))
        fin, acts, rs, bests = mpc.make_fused_mpc_rollout(m, cfg, 2)(
            st, torch.Generator().manual_seed(1))
    assert pl.mean.shape == (2, m.cfg.action_dim) and best.shape == ()
    assert bool((pl.mean.abs() <= high).all())
    assert acts.shape == (2, m.cfg.action_dim) and rs.shape == (2,)
    assert bests.shape == (2,) and bool(torch.isfinite(bests).all())
    np.testing.assert_array_equal(fin.t.numpy(), z["in_t"][:1] + 2)
    assert bool(torch.isfinite(fin.q).all())


def test_cuda_backend_on_cpu_tensors_raises():
    """No fallback: the planners asked for "cuda" on CPU tensors raise at
    their first kernel call."""
    m = core.build_model(CATALOG["UR5Reach-v0"])
    z = tp.load("rollout_UR5Reach")
    st = interop.state_from_numpy(
        {k[3:]: v[:2] for k, v in z.items() if k.startswith("in_")}, "cpu")
    cfg = mpc.MPCConfig(horizon=1, pop=2, iters=1)
    g = torch.Generator()
    with pytest.raises(ValueError, match="CUDA tensor"):
        mpc.make_fused_planner(m, cfg, backend="cuda")(
            EnvState(**{k: v[:1] for k, v in vars(st).items()}),
            mpc.init_plan(m, cfg, device="cpu"), g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mpc.make_batched_fused_mpc_step(m, cfg, 2, backend="cuda")(
            st, mpc.init_batched_plan(m, cfg, 2, device="cpu"), g)
    assert fs.LAUNCHES == {"sim": 0, "step": 0, "rollout": 0}

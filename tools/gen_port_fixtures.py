"""Write the JAX outputs that the PyTorch port is held to.

The port's CPU tests (tests/test_torch_*.py) and the parity phase of
chip_smoke.py compare the port with the JAX package on the same inputs.
Compiling the JAX lane twin costs minutes per program on a small CPU host,
so the JAX side is computed once, here, and committed as small npz files
under tests/torch_fixtures/. The JAX package is used unchanged, on the CPU,
through its plain references (make_reference_sim / make_reference_step /
make_lane_control / make_fused_rollout_whole(backend="reference")), at
jax_default_matmul_precision="highest" as tests/conftest.py sets it.

Every file records the sha256 of the JAX sources its numbers depend on; a
port test fails with "regenerate with tools/gen_port_fixtures.py" when one
of them changes.

    python tools/gen_port_fixtures.py                 # every fixture
    python tools/gen_port_fixtures.py --only sim3_UR5Reach step12

All inputs come from numpy seeds, except the UR5PlayAbsRPY1Obj start states,
which are a jitted batched_reset, the MPC normals and the reset's goal
draws, which jax.random draws and the fixture stores, and the env fixtures
(golden_lane_*, proprio), which start from the golden files' injected
states (tests/golden/*.npz). The physics fixtures are B=128; the MPC ones
(mpc_*) are as small as their cases allow.

    python tools/gen_port_fixtures.py --only $(python tools/gen_port_fixtures.py --list | grep golden_lane)

writes the 19 lane replays of the goldens, 25 steps each (a few minutes for
a UR5 id on a CPU, ~8 min for a Panda id on two cores; XLA's compile uses
every core, so pin parallel processes to their own cores with taskset).
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from roboticsplayroompybullet_tpu.envs.config import CATALOG  # noqa: E402
from roboticsplayroompybullet_tpu.envs import core  # noqa: E402
from roboticsplayroompybullet_tpu.envs.state import EnvState  # noqa: E402
from roboticsplayroompybullet_tpu.ops import fused_step as fs  # noqa: E402
from roboticsplayroompybullet_tpu.parallel import fused as F  # noqa: E402
from roboticsplayroompybullet_tpu.parallel import rollout as R  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures")
B = 128
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"
STATE_FIELDS = ("q", "qd", "ctrl_q", "grip", "obj_pos", "obj_quat",
                "obj_vel", "obj_angvel", "art_q", "art_qd", "goal",
                "prev_obs", "prev_ag", "has_prev", "rng", "t")

# the JAX sources whose behaviour the fixtures record
SOURCES = sorted(
    ["roboticsplayroompybullet_tpu/ops/fused_step.py",
     "roboticsplayroompybullet_tpu/ops/lane.py",
     "roboticsplayroompybullet_tpu/envs/config.py",
     "roboticsplayroompybullet_tpu/envs/rewards.py",
     "roboticsplayroompybullet_tpu/parallel/fused.py",
     "roboticsplayroompybullet_tpu/solver/cost.py",
     "roboticsplayroompybullet_tpu/solver/mpc.py",
     "roboticsplayroompybullet_tpu/solver/eval.py",
     "roboticsplayroompybullet_tpu/envs/obs.py",
     "roboticsplayroompybullet_tpu/ops/dynamics.py",
     "roboticsplayroompybullet_tpu/ops/spatial.py",
     "roboticsplayroompybullet_tpu/ops/kinematics.py",
     "roboticsplayroompybullet_tpu/envs/core.py",
     "roboticsplayroompybullet_tpu/envs/physics.py",
     "roboticsplayroompybullet_tpu/utils/render.py"]
    + [os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "roboticsplayroompybullet_tpu/models/*.py"))])


def source_hashes() -> dict:
    out = {}
    for rel in SOURCES:
        with open(os.path.join(ROOT, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def _save(name: str, **arrays):
    os.makedirs(OUT, exist_ok=True)
    arrays["sources_json"] = np.array(json.dumps(source_hashes()))
    path = os.path.join(OUT, name + ".npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    print(f"wrote {os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path)} bytes)", flush=True)


def _state_dict(st: EnvState) -> dict:
    return {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}


def _state_of(d: dict) -> EnvState:
    return EnvState(**{f: jnp.asarray(d[f]) for f in STATE_FIELDS})


def _key(env_id: str) -> str:
    return env_id.replace("-v0", "")


# ---------------------------------------------------------------------------
# start states
# ---------------------------------------------------------------------------

def flagship_reset() -> dict:
    """Jitted batched_reset of the flagship env (cached on disk)."""
    path = os.path.join(OUT, f"reset_{_key(FLAGSHIP)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {f: z[f] for f in STATE_FIELDS}
    m = core.build_model(CATALOG[FLAGSHIP])
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st, _ = jax.jit(lambda k: R.batched_reset(m, k))(keys)
    d = _state_dict(st)
    _save(f"reset_{_key(FLAGSHIP)}", **d)
    return d


def noised(d: dict, m, seed: int) -> dict:
    """Reset states with the velocity/servo/gripper noise of
    tests/test_fused.py::_setup, drawn from numpy."""
    rs = np.random.RandomState(seed)
    d = dict(d)
    d["qd"] = (rs.standard_normal(d["qd"].shape) * 0.3).astype(np.float32)
    d["grip"] = rs.uniform(0.0, 1.0, d["grip"].shape).astype(np.float32)
    d["ctrl_q"] = (d["ctrl_q"] + rs.uniform(
        -0.1, 0.1, d["ctrl_q"].shape)).astype(np.float32)
    return d


def synthetic_states(m, seed: int) -> dict:
    """numpy-seeded start states for envs without a reset dump: arm near
    its rest pose, blocks resting on (or slightly in) their support, a
    few stacked. (A block squeezed between the pads is left out: that
    contact is stiff enough that two float32 evaluation orders part by
    ~1e-4 rad/s in its spin within 3 substeps, which is rounding, not a
    fault, and would hide real faults behind the 1e-4 bound.)"""
    cfg, tree, arm, scene = m.cfg, m.tree, m.arm, m.scene
    rs = np.random.RandomState(seed)
    n, na, no = tree.n_dof, arm.n_arm, max(cfg.num_objects, 1)
    lo, hi = np.asarray(tree.lower), np.asarray(tree.upper)
    q = np.zeros((B, n), np.float32)
    q[:, :na] = np.asarray(arm.rest_pose, np.float32)
    q[:, :na] += rs.uniform(-0.25, 0.25, (B, na))
    q[:, na:] = lo[na:] + rs.uniform(0.0, 0.5, (B, n - na)) * (hi - lo)[na:]
    q = np.clip(q, lo, hi).astype(np.float32)
    d = dict(
        q=q,
        qd=(rs.standard_normal((B, n)) * 0.3).astype(np.float32),
        ctrl_q=(q[:, :na] + rs.uniform(-0.1, 0.1, (B, na))).astype(np.float32),
        grip=rs.uniform(0.0, 1.0, B).astype(np.float32),
        obj_pos=np.zeros((B, no, 3), np.float32),
        obj_quat=np.tile(np.array([0, 0, 0, 1], np.float32), (B, no, 1)),
        obj_vel=np.zeros((B, no, 3), np.float32),
        obj_angvel=np.zeros((B, no, 3), np.float32),
        art_q=np.zeros((B, 4), np.float32),
        art_qd=np.zeros((B, 4), np.float32),
        goal=np.zeros((B, cfg.goal_dim), np.float32),
        prev_obs=np.zeros((B, cfg.obs_dim), np.float32),
        prev_ag=np.zeros((B, cfg.ag_dim), np.float32),
        has_prev=np.zeros(B, bool),
        rng=np.zeros((B, 2), np.uint32),
        t=np.zeros(B, np.int32),
    )
    pos_l, quat_l = fs.lane_fk_links(tree, jnp.asarray(q.T))
    ee, _ = fs._lane_site_pose(tree, pos_l, quat_l, arm.ee_site)
    ee = np.asarray(ee).T                                    # (B, 3)
    if cfg.num_objects:
        hz = float(scene.block_half[2])
        top = 0.0 if cfg.play else float(scene.plane_z) + hz
        for o in range(cfg.num_objects):
            xy = rs.uniform(-0.15, 0.15, (B, 2))
            if cfg.play:
                xy[:, 1] = rs.uniform(0.0, 0.3, B)
            z = top + rs.uniform(-0.004, 0.004, B) + 2 * hz * o
            yaw = rs.uniform(-np.pi, np.pi, B)
            tilt = rs.uniform(-0.05, 0.05, (B, 2))
            qt = np.stack([tilt[:, 0], tilt[:, 1], np.sin(yaw / 2),
                           np.cos(yaw / 2)], -1)
            qt /= np.linalg.norm(qt, axis=-1, keepdims=True)
            pos = np.concatenate([xy, z[:, None]], -1)
            d["obj_pos"][:, o] = pos
            d["obj_quat"][:, o] = qt
            d["obj_vel"][:, o] = rs.standard_normal((B, 3)) * 0.05
            d["obj_angvel"][:, o] = rs.standard_normal((B, 3)) * 0.2
        if cfg.num_objects == 2:                         # stacked pairs
            d["obj_pos"][1::4, 1] = d["obj_pos"][1::4, 0] + [0.0, 0.0, 2 * hz]
    if cfg.play:
        alo = np.asarray(scene.art_lower, np.float32)
        ahi = np.asarray(scene.art_upper, np.float32)
        alo[3], ahi[3] = -3.0, 3.0                       # dial, both signs
        d["art_q"] = (alo + rs.uniform(0, 1, (B, 4)) * (ahi - alo)
                      ).astype(np.float32)
        d["art_qd"] = (rs.standard_normal((B, 4)) * 0.1).astype(np.float32)
        d["goal"] = (np.zeros((B, cfg.goal_dim))
                     + rs.uniform(-0.1, 0.1, (B, cfg.goal_dim))
                     ).astype(np.float32)
    else:
        goal = ee + rs.uniform(-0.06, 0.06, (B, 3))
        d["goal"] = np.tile(goal, (1, cfg.num_goals)).astype(np.float32)
    return d


def start_states(env_id: str, seed: int) -> dict:
    cfg = CATALOG[env_id]
    m = core.build_model(cfg)
    if cfg.arm == "UR5" and cfg.play and cfg.num_objects == 1:
        return noised(flagship_reset(), m, seed)
    return synthetic_states(m, seed)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

SIM3_ENVS = (FLAGSHIP, "UR5Reach-v0", "pandaPick-v0", "pandaPlay-v0")
# one env per action decode mode, as tests/test_fused.py:67-78
CONTROL_ENVS = ("pandaPlayAbsRPY1Obj-v0", "UR5PlayRelRPY1Obj-v0",
                "pandaPlay1Obj-v0", "UR5PlayRel1Obj-v0",
                "pandaPlayRelJoints1Obj-v0", "UR5PlayAbsJoints1Obj-v0")
# (env, horizon, substeps): full fidelity on the flagship, the lane-FK
# achieved-goal branch on reach at 3 substeps
ROLLOUTS = ((FLAGSHIP, 2, None), ("UR5Reach-v0", 2, 3))


def make_sim3(env_id: str):
    m = core.build_model(CATALOG[env_id])
    d = start_states(env_id, seed=1)
    st = _state_of(d)
    X = fs.pack_state(m.cfg, m.tree, st)
    ctrl = jnp.asarray(d["ctrl_q"].T)
    grip = jnp.asarray(d["grip"])
    sim = fs.make_reference_sim(m.cfg, m.tree, m.arm, m.scene, n_substeps=3)
    X2 = jax.jit(sim)(X, ctrl, grip)
    _save(f"sim3_{_key(env_id)}", X=X, ctrl=ctrl, grip=grip, X_out=X2,
          n_substeps=np.int32(3))


def make_control(env_id: str):
    m = core.build_model(CATALOG[env_id])
    d = start_states(env_id, seed=2)
    rs = np.random.RandomState(3)
    acts = rs.uniform(-0.5, 0.5, (m.cfg.action_dim, B)).astype(np.float32)
    ctrl = fs.make_lane_control(m.cfg, m.tree, m.arm)
    t, g = jax.jit(ctrl)(jnp.asarray(d["q"].T), jnp.asarray(acts))
    _save(f"control_{_key(env_id)}", q=d["q"].T, actions=acts, targets=t,
          grip=g)


def make_step12():
    m = core.build_model(CATALOG[FLAGSHIP])
    d = start_states(FLAGSHIP, seed=5)
    X = fs.pack_state(m.cfg, m.tree, _state_of(d))
    rs = np.random.RandomState(6)
    acts = rs.uniform(-0.3, 0.3, (m.cfg.action_dim, B)).astype(np.float32)
    step = fs.make_reference_step(m.cfg, m.tree, m.arm, m.scene)
    X2 = jax.jit(step)(X, jnp.asarray(acts))
    _save(f"step12_{_key(FLAGSHIP)}", X=X, actions=acts, X_out=X2)


REWARD_ENVS = (FLAGSHIP, "pandaPlay-v0", "pandaPick-v0", "UR5Reach-v0")


def make_rewards():
    """compute_reward (play success, sparse, dense) on random goals near
    the ags, and dense_reward, for one env of each reward family."""
    from roboticsplayroompybullet_tpu.envs import rewards as jr
    out = {}
    for env_id in REWARD_ENVS:
        cfg = CATALOG[env_id]
        rs = np.random.RandomState(4)
        ag = rs.uniform(-0.3, 0.3, (64, 3, cfg.ag_dim)).astype(np.float32)
        g = (ag[:, :1] + rs.uniform(-0.06, 0.06, (64, 1, cfg.ag_dim))
             ).astype(np.float32)
        if not cfg.play:
            g = g[..., :3 * cfg.num_goals]
        k = _key(env_id)
        out.update({
            f"{k}_ag": ag, f"{k}_goal": g,
            f"{k}_reward": jr.compute_reward(cfg, jnp.asarray(ag),
                                             jnp.asarray(g)),
            f"{k}_dense": jr.dense_reward(jnp.asarray(ag),
                                          jnp.asarray(ag) * 0.5)})
    _save("rewards", **out)


def make_rollout(env_id: str, H: int, n_substeps):
    cfg = CATALOG[env_id]
    m = core.build_model(cfg)
    d = start_states(env_id, seed=11)
    rs = np.random.RandomState(12)
    acts = rs.uniform(-0.25, 0.25, (B, H, cfg.action_dim)).astype(np.float32)
    roll = F.make_fused_rollout_whole(m, H, backend="reference",
                                      n_substeps=n_substeps)
    fin, rew, ags = jax.jit(roll)(_state_of(d), jnp.asarray(acts))
    out = {f"in_{k}": v for k, v in d.items()}
    out.update({f"out_{k}": v for k, v in _state_dict(fin).items()})
    _save(f"rollout_{_key(env_id)}", actions=acts, rewards=rew, ags=ags,
          horizon=np.int32(H),
          n_substeps=np.int32(n_substeps or cfg.substeps), **out)


# ---------------------------------------------------------------------------
# the MPC solver (solver/cost.py, solver/mpc.py), eager except the MPC step
# ---------------------------------------------------------------------------

# (name, env, use_orientation override): play with one and two blocks, the
# object layout with a stride of 3 and of 7, and reach
COST_CASES = (("play1", FLAGSHIP, None), ("play2", "pandaPlay-v0", None),
              ("obj", "pandaPick-v0", None), ("obj_orn", "pandaPick-v0", True),
              ("reach", "UR5Reach-v0", None))
# one env per branch of init_plan_from_state
INIT_ENVS = (FLAGSHIP, "UR5Reach-v0", "pandaPlay1Obj-v0",
             "UR5PlayAbsJoints1Obj-v0", "UR5PlayRelRPY1Obj-v0")
MPC_STEP = dict(n_envs=2, horizon=2, pop=64, iters=2, n_substeps=1)
# JAX's closed loop on UR5Reach, at a size the CPU runs in seconds
MPC_LOOP = dict(horizon=2, pop=128, iters=2, n_steps=2, n_substeps=1)


def _mpc():
    from roboticsplayroompybullet_tpu import solver as sol
    from roboticsplayroompybullet_tpu.solver import mpc
    return sol, mpc


def make_mpc_cost():
    """goal_distance / trajectory_cost on every goal layout: (n, H, ag)
    achieved goals near the goal, a third of them with the block quats
    equal to the goal's (the arccos clip)."""
    sol, _ = _mpc()
    out = {}
    n, H = 16, 4
    for name, env_id, orn in COST_CASES:
        cfg = CATALOG[env_id]
        if orn is not None:
            cfg = dataclasses.replace(cfg, use_orientation=orn)
        rs = np.random.RandomState(len(out))
        ag_dim = cfg.ag_dim
        g = rs.uniform(-0.3, 0.3, (n, cfg.goal_dim)).astype(np.float32)
        ag = rs.uniform(-0.3, 0.3, (n, H, ag_dim)).astype(np.float32)
        if cfg.play:
            ag = (np.broadcast_to(g[:, None], ag.shape)
                  + rs.uniform(-0.05, 0.05, ag.shape)).astype(np.float32)
            for o in range(cfg.num_objects):
                sl = slice(7 * o + 3, 7 * o + 7)
                ag[: n // 3, :, sl] = g[: n // 3, None, sl]
        acts = rs.uniform(-1, 1, (n, H, cfg.action_dim)).astype(np.float32)
        w = sol.CostWeights()
        d = sol.goal_distance(cfg, jnp.asarray(ag), jnp.asarray(g)[:, None], w)
        c = jax.vmap(lambda a_, g_, u_: sol.trajectory_cost(
            cfg, a_, g_, u_, w))(jnp.asarray(ag), jnp.asarray(g),
                                 jnp.asarray(acts))
        out.update({f"{name}_ag": ag, f"{name}_goal": g, f"{name}_acts": acts,
                    f"{name}_dist": d, f"{name}_cost": c})
    _save("mpc_cost", **out)


def make_mpc_init():
    """init_plan_from_state for each action mode, on 8 start states."""
    _, mpc = _mpc()
    cfg_mpc = mpc.MPCConfig(horizon=3)
    out = {}
    for env_id in INIT_ENVS:
        m = core.build_model(CATALOG[env_id])
        d = {k: v[:8] for k, v in start_states(env_id, seed=13).items()}
        pl = jax.vmap(lambda s: mpc.init_plan_from_state(m, cfg_mpc, s))(
            _state_of(d))
        k = _key(env_id)
        out.update({f"{k}_q": d["q"], f"{k}_qd": d["qd"],
                    f"{k}_mean": pl.mean, f"{k}_sigma": pl.sigma})
    _save("mpc_init", horizon=np.int32(cfg_mpc.horizon), **out)


def make_mpc_sample():
    """_sample's AR(1)/clip transform on the normals jax.random draws from a
    fixed key; means near the bounds so the clip engages."""
    _, mpc = _mpc()
    cfg = mpc.MPCConfig()
    high = np.asarray(CATALOG[FLAGSHIP].action_high, np.float32)
    rs = np.random.RandomState(14)
    n, H = 32, 5
    mean = (rs.uniform(-0.95, 0.95, (H, len(high))) * high).astype(np.float32)
    sigma = rs.uniform(0.1, 1.5, (H, len(high))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(key, (n, H, len(high)), jnp.float32)
    acts = mpc._sample(key, mpc.PlanState(jnp.asarray(mean),
                                          jnp.asarray(sigma)),
                       cfg, n, jnp.asarray(high))
    _save("mpc_sample", mean=mean, sigma=sigma, high=high, noise=noise,
          actions=acts, smooth=np.float32(cfg.smooth))


def make_mpc_update():
    """_mppi_update / _cem_update on fixed actions and costs, two envs;
    the costs are rounded to 0.1 so that CEM's k-th cost has ties."""
    _, mpc = _mpc()
    cfg = mpc.MPCConfig(pop=64)
    rs = np.random.RandomState(15)
    E, H, A = 2, 4, 7
    acts = rs.uniform(-1, 1, (E, cfg.pop, H, A)).astype(np.float32)
    costs = (np.round(rs.uniform(0, 2, (E, cfg.pop)) * 10) / 10
             ).astype(np.float32)
    mean = rs.uniform(-1, 1, (E, H, A)).astype(np.float32)
    sigma = rs.uniform(0.1, 0.5, (E, H, A)).astype(np.float32)
    out = {}
    for name, fn in (("mppi", mpc._mppi_update), ("cem", mpc._cem_update)):
        pl = jax.vmap(lambda mu, s, a, c: fn(mpc.PlanState(mu, s), cfg, a, c,
                                              None))(
            jnp.asarray(mean), jnp.asarray(sigma), jnp.asarray(acts),
            jnp.asarray(costs))
        out.update({f"{name}_mean": pl.mean, f"{name}_sigma": pl.sigma})
    _save("mpc_update", actions=acts, costs=costs, mean=mean, sigma=sigma,
          pop=np.int32(cfg.pop), elite_frac=np.float32(cfg.elite_frac),
          **out)


def mpc_step_cost(sol, cfg, w):
    """The MPC step fixture's cost_fn: trajectory_cost plus a per-env
    weight (cost_params["reach"]) times the summed ee-to-block distance,
    read from the with_ee tail of the preview ags."""
    def cost(ag1, g1, a1, p1):
        reach = jnp.sum(jnp.linalg.norm(ag1[:, -3:] - ag1[:, 0:3], axis=-1))
        return sol.trajectory_cost(cfg, ag1, g1, a1, w) + p1["reach"] * reach
    return cost


def make_mpc_step():
    """One make_batched_fused_mpc_step(backend="reference") on the flagship
    (MPC_STEP: 2 envs x 64 candidates, H=2, 2 iterations, 1 substep), with
    with_ee and a cost_fn that reads the ee tail and cost_params. The
    normals each iteration draws are stored so the port can use them."""
    sol, mpc = _mpc()
    m = core.build_model(CATALOG[FLAGSHIP])
    E, H, pop, iters = (MPC_STEP[k] for k in ("n_envs", "horizon", "pop",
                                              "iters"))
    cfg = mpc.MPCConfig(horizon=H, pop=pop, iters=iters, algorithm="mppi",
                        sigma_init=0.3)
    d = {k: v[:E] for k, v in noised(flagship_reset(), m, 21).items()}
    st = _state_of(d)
    plans = mpc.init_batched_plan(m, cfg, E, st)
    params = {"reach": jnp.asarray([0.5, 1.0], jnp.float32)}
    step = mpc.make_batched_fused_mpc_step(
        m, cfg, E, backend="reference", n_substeps=MPC_STEP["n_substeps"],
        cost_fn=mpc_step_cost(sol, m.cfg, cfg.weights), with_ee=True)
    key = jax.random.PRNGKey(8)
    A = m.cfg.action_dim
    normals = np.stack([np.stack([
        np.asarray(jax.random.normal(kk, (pop, H, A), jnp.float32))
        for kk in jax.random.split(k, E)])
        for k in jax.random.split(key, iters)])       # (iters, E, pop, H, A)
    st2, pl2, rew, ags = jax.jit(step)(st, plans, key, params)
    out = {f"in_{k}": v for k, v in d.items()}
    out.update({f"out_{k}": v for k, v in _state_dict(st2).items()})
    _save(f"mpc_step_{_key(FLAGSHIP)}", normals=normals,
          plan_mean=plans.mean, plan_sigma=plans.sigma, reach=params["reach"],
          out_mean=pl2.mean, out_sigma=pl2.sigma, rewards=rew, ags=ags,
          sigma_init=np.float32(cfg.sigma_init),
          **{k: np.int32(v) for k, v in MPC_STEP.items()}, **out)


def make_mpc_loop():
    """JAX's make_fused_mpc_rollout on the first UR5Reach start state of the
    rollout_UR5Reach fixture, from init_plan's zero mean, by MPPI and by
    CEM, at MPC_LOOP's size (1 substep, so the CPU runs it in seconds). The
    loop is built with its kernels swapped for their plain twins
    (make_fused_rollout_whole with backend="reference", make_pallas_step →
    make_reference_step, for the duration of the build; they compute the
    same functions). The normals each replan iteration draws are stored,
    so the port's loop can run on them."""
    _, mpc = _mpc()
    cfg = dataclasses.replace(CATALOG["UR5Reach-v0"],
                              substeps=MPC_LOOP["n_substeps"])
    m = core.build_model(cfg)
    H, pop, iters, T = (MPC_LOOP[k] for k in ("horizon", "pop", "iters",
                                              "n_steps"))
    with np.load(os.path.join(OUT, "rollout_UR5Reach.npz")) as z:
        d = {f: z[f"in_{f}"][0] for f in STATE_FIELDS}
    key = jax.random.PRNGKey(9)
    normals = np.stack([np.stack([
        np.asarray(jax.random.normal(ki, (pop, H, cfg.action_dim),
                                     jnp.float32))
        for ki in jax.random.split(kt, iters)])
        for kt in jax.random.split(key, T)])         # (T, iters, pop, H, A)
    whole, pallas_step = F.make_fused_rollout_whole, fs.make_pallas_step
    out = {f"in_{k}": v for k, v in d.items()}
    for algo in ("mppi", "cem"):
        F.make_fused_rollout_whole = (
            lambda *a, **k: whole(*a, **dict(k, backend="reference")))
        fs.make_pallas_step = (
            lambda *a, block_envs=None, interpret=None, **k:
            fs.make_reference_step(*a, **k))
        try:
            run = mpc.make_fused_mpc_rollout(
                m, mpc.MPCConfig(horizon=H, pop=pop, iters=iters,
                                 algorithm=algo), T)
        finally:
            F.make_fused_rollout_whole, fs.make_pallas_step = (
                whole, pallas_step)
        fin, acts, rews, bests = jax.jit(run)(_state_of(d), key)
        out.update({f"{algo}_out_{k}": v
                    for k, v in _state_dict(fin).items()})
        out.update({f"{algo}_actions": acts, f"{algo}_rewards": rews,
                    f"{algo}_bests": bests})
    _save("mpc_loop_UR5Reach", normals=normals, **out,
          **{k: np.int32(v) for k, v in MPC_LOOP.items()})


# ---------------------------------------------------------------------------
# the env layer (envs/core.py, envs/obs.py, solver/mpc.py's mpc_rollout)
# ---------------------------------------------------------------------------

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
OBS_KEYS = ("obs_quat", "achieved_goal", "desired_goal",
            "controllable_achieved_goal", "full_positional_state", "joints",
            "velocity", "observation", "gripper_proprioception")
# tests/test_golden.py:63-77
GOLDEN_BOUNDS = dict(ee=2e-3, ag=5e-3, q=2e-2)
# JAX's mpc_rollout (the non-fused planner on core.step_physics_only) on
# UR5Reach, at a size the CPU runs in seconds
MPC_PLAN_LOOP = dict(horizon=2, pop=8, iters=2, n_steps=2, n_substeps=1)


def golden(env_id: str) -> dict:
    with np.load(os.path.join(GOLDEN_DIR,
                              env_id.replace("-", "_") + ".npz")) as z:
        return {k: z[k] for k in z.files}


def reset_goal_draws(cfg, key) -> dict:
    """The draws core.reset's reset_goal makes from `key` (its 4th split):
    play → the perturbed dim and its U(0, 1) offset; else one U(0, 1)^3
    per goal, before the scaling to the goal range."""
    k3 = jax.random.split(key, 4)[3]
    if cfg.play:
        k1, k2 = jax.random.split(k3)
        return {"goal_idx": np.int32(jax.random.randint(k1, (), 0,
                                                        cfg.goal_dim)),
                "goal_u": np.asarray(jax.random.uniform(k2, (), jnp.float32))}
    keys = jax.random.split(k3, cfg.num_goals)
    return {"goal_u": np.stack([np.asarray(jax.random.uniform(
        k, (3,), jnp.float32)) for k in keys])}


def _obs_fn(m):
    from roboticsplayroompybullet_tpu.envs import obs as O
    return jax.jit(lambda s: O.calc_obs(m.cfg, m.tree, m.arm, m.scene, s))


def _obs_out(prefix: str, o: dict) -> dict:
    return {f"{prefix}_{k}": np.asarray(o[k]) for k in OBS_KEYS}


# envs of the lane tile the golden replays step: make_reference_step's
# body on an (NF, 1, LANE_TILE) tile instead of its 128-wide one, per env
# the same JAX operations at a sixteenth of the cost (~33 core-seconds a
# Panda step on a CPU, where the 128-wide tile takes ~500). XLA vectorises
# the two widths differently, so they agree to float32 rounding, not bit
# for bit: of the 128-wide replays this file wrote before, pandaReach's 25
# steps are identical, pandaPlayRel1Obj's first within 8.3e-7, and
# pandaPlayRelRPY1Obj's within 1.6e-4 until its ill-conditioned IK step
# 14, where the two part as any two roundings do
LANE_TILE = 8


def lane_step(m):
    """JAX's make_reference_step body (the lane control, then the lane sim,
    solve 8, the arm's IK iterations) on X (NF, 1, LANE_TILE) and actions
    (A, 1, LANE_TILE)."""
    control = fs.make_lane_control(m.cfg, m.tree, m.arm)
    sim = fs.make_lane_sim(m.cfg, m.tree, m.arm, m.scene, None,
                           solve_iters=8)

    def step(X3, A3):
        st = fs._lanes_from_block(m.cfg, m.tree, X3)
        ctrl, grip = control(st["q"], A3)
        return fs._block_from_lanes(m.cfg, m.tree, sim(st, ctrl, grip))

    return step


def make_golden_lane(env_id: str):
    """One golden's replay through the JAX package's lane twin (lane_step on
    LANE_TILE tiled copies of the one env, all 25 steps) from JAX's
    core.reset(o=g["o0"]), with calc_obs and the continuity buffers after
    every step as core.step threads them. Records the reset state, its obs
    and goal draws; per step the packed X, ee, ag and q; the full obs of the
    first step's state and of that state with negated continuity buffers
    (so the play envs' _flip_quats fires); and the replay's own distance to
    the golden."""
    cfg = CATALOG[env_id]
    m = core.build_model(cfg)
    g = golden(env_id)
    key = jax.random.PRNGKey(0)
    st0, obs0 = jax.jit(lambda k, o: core.reset(m, k, o))(
        key, jnp.asarray(g["o0"]))
    calc = _obs_fn(m)
    L = LANE_TILE
    tile = lambda x: jnp.broadcast_to(x, (L,) + x.shape)  # noqa: E731
    first = jax.jit(lambda X, st: jax.tree.map(
        lambda v: v[0], fs.unpack_state(cfg, m.tree, X,
                                        jax.tree.map(tile, st))))
    X0 = np.asarray(fs.pack_state(cfg, m.tree, jax.tree.map(tile, st0)))
    NF = X0.shape[0]
    # compiled once, ahead of time: a jitted call may trace and compile
    # again on a later step's inputs, at a minute or two each
    step = jax.jit(lane_step(m)).lower(
        jax.ShapeDtypeStruct((NF, 1, L), jnp.float32),
        jax.ShapeDtypeStruct((cfg.action_dim, 1, L), jnp.float32)).compile()
    X = jnp.asarray(X0, jnp.float32)
    X0 = X0[:, 0]
    st = st0
    Xs, ee, ag, q = [], [], [], []
    out = {}
    for t, a in enumerate(g["actions"]):
        t0 = time.time()
        X = step(X.reshape(NF, 1, L), jnp.asarray(np.broadcast_to(
            np.asarray(a, np.float32)[:, None, None],
            (a.shape[0], 1, L)))).reshape(NF, L)
        Xn = np.asarray(X)
        assert (Xn == Xn[:, :1]).all(), (env_id, t)
        st = first(X, st)
        o = calc(st)
        st = st.replace(prev_obs=o["_prev_obs"], prev_ag=o["_prev_ag"],
                        has_prev=jnp.ones((), bool),
                        t=(st.t + 1).astype(jnp.int32))
        if t == 0:
            out.update(_obs_out("obs1", o))
            out.update({f"st1_{k}": v for k, v in _state_dict(st).items()})
            flip = st.replace(prev_obs=-o["obs_quat"],
                              prev_ag=-o["achieved_goal"])
            out.update(_obs_out("flip", calc(flip)))
        Xs.append(Xn[:, 0])
        ee.append(np.asarray(o["controllable_achieved_goal"][:3]))
        ag.append(np.asarray(o["achieved_goal"]))
        q.append(np.asarray(st.q))
        print(f"{env_id} step {t + 1}: {time.time() - t0:.1f} s", flush=True)
    Xs, ee, ag, q = map(np.stack, (Xs, ee, ag, q))
    err = {"ee": np.linalg.norm(ee - g["ee"], axis=-1),
           "ag": np.abs(ag - g["ag"]).max(-1),
           "q": np.abs(q - g["q"]).max(-1)}
    for k, e in err.items():
        t = int(np.argmax(e))
        print(f"{env_id} lane vs golden {k}: max {e.max():.3e} at step "
              f"{t + 1} (bound {GOLDEN_BOUNDS[k]:g})", flush=True)
    _save(f"golden_lane_{_key(env_id)}", o0=g["o0"], actions=g["actions"],
          X0=X0, X=Xs, ee=ee, ag=ag, q=q,
          **{f"err_{k}": v for k, v in err.items()},
          **{f"reset_{k}": v for k, v in _state_dict(st0).items()},
          **_obs_out("reset", obs0), **reset_goal_draws(cfg, key), **out)


# envs of each settle fixture, and its envs: the flagship (one block) and
# pandaPlay (two blocks, block-block rows)
SETTLE_B = 512
SETTLE_ENVS = (FLAGSHIP, "pandaPlay-v0")


def make_settle(env_id: str):
    """One random placement and the 100-substep settle of reset's
    _place_and_settle (JAX core, the oracle physics), on SETTLE_B default
    states at rest, each from its own jax.random key. Records the U(0, 1)
    draws jax.random.uniform made for each object (so the port's _uniform
    can replay them), the placed positions and the settled object state."""
    cfg = CATALOG[env_id]
    m = core.build_model(cfg)
    keys = jax.random.split(jax.random.PRNGKey(30), SETTLE_B)

    def one(k):
        st = core._default_state(m, k)
        st = st.replace(art_q=jnp.zeros(4, jnp.float32),
                        art_qd=jnp.zeros(4, jnp.float32))
        ks = jax.random.split(k, cfg.num_objects)
        u = jnp.stack([jax.random.uniform(ki, (3,), jnp.float32)
                       for ki in ks])
        return u, core._place_and_settle(m, st, k)

    t0 = time.time()
    u, st = jax.jit(jax.vmap(one))(keys)
    jax.block_until_ready(st)
    print(f"{env_id} settle B={SETTLE_B}: {time.time() - t0:.1f} s",
          flush=True)
    lo = np.asarray(cfg.obj_lower_bound, np.float32)
    hi = np.asarray(cfg.obj_upper_bound, np.float32)
    placed = np.maximum(lo, np.asarray(u) * (hi - lo) + lo)
    placed[..., 2] += 0.03 * (np.arange(cfg.num_objects) + 1)
    _save(f"settle_{_key(env_id)}", u=u, placed=placed,
          **{f"out_{k}": np.asarray(getattr(st, k))
             for k in ("q", "qd", "obj_pos", "obj_quat", "obj_vel",
                       "obj_angvel")})


def make_proprio():
    """calc_obs's gripper proprioception on the cases of
    tests/test_proprioception.py, from the flagship's and the Panda
    flagship's reset(o=golden o0) states: a block on the ray segment but
    off the inter-pad midpoint, the block far away, and the Panda."""
    from roboticsplayroompybullet_tpu.envs import obs as O
    from roboticsplayroompybullet_tpu.ops import dynamics as dyn
    from roboticsplayroompybullet_tpu.ops import spatial as sp
    out = {}
    for name, env_id in (("ur5", FLAGSHIP), ("panda",
                                             "pandaPlayAbsRPY1Obj-v0")):
        m = core.build_model(CATALOG[env_id])
        st, _ = jax.jit(lambda k, o: core.reset(m, k, o))(
            jax.random.PRNGKey(0), jnp.asarray(golden(env_id)["o0"]))
        calc = _obs_fn(m)
        cases = {"rest": st}
        if name == "ur5":
            # the segment of obs._proprioception, as the JAX test builds it
            kin = dyn.fk_vel(m.tree, st.q, st.qd)
            centers = []
            for site, off, _r in m.arm.pad_spheres:
                par = m.tree.site_parent[site]
                spos, squat = sp.transform_compose(
                    kin.pos[par], kin.quat[par], m.tree.site_pos[site],
                    m.tree.site_quat[site])
                centers.append(spos + sp.quat_rotate(
                    squat, jnp.asarray(off, jnp.float32)))
            avg_pad = jnp.mean(jnp.stack(centers), axis=0)
            ee_pos = O.ee_state(m.tree, m.arm, kin)[0]
            wrist = kin.pos[int(m.tree.parent[m.tree.site_parent[
                m.arm.ee_site]])]
            p1 = ee_pos - (ee_pos - wrist) * 0.5
            p2 = avg_pad + (ee_pos - wrist) * 0.2
            c = p1 + 0.25 * (p2 - p1)
            assert float(jnp.linalg.norm(c - avg_pad)) > float(
                np.max(m.scene.block_half)) + 0.01
            ident = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
            cases = {"on_ray": st.replace(
                obj_pos=st.obj_pos.at[0].set(c),
                obj_quat=st.obj_quat.at[0].set(ident)),
                "far": st.replace(obj_pos=st.obj_pos.at[0].set(
                    jnp.array([5.0, 5.0, 5.0], jnp.float32)))}
        for case, s in cases.items():
            out.update({f"{name}_{case}_{k}": v
                        for k, v in _state_dict(s).items()})
            out[f"{name}_{case}_prop"] = np.asarray(
                calc(s)["gripper_proprioception"])
            print(name, case, out[f"{name}_{case}_prop"], flush=True)
    _save("proprio", **out)


def make_mpc_plan_loop():
    """JAX's mpc_rollout (the single-device `plan` on
    core.step_physics_only) on the first UR5Reach start state of the
    rollout_UR5Reach fixture, from init_plan's zero mean, by MPPI and by
    CEM, at MPC_PLAN_LOOP's size. The normals each replan iteration draws
    are stored, so the port's loop can run on them."""
    _, mpc = _mpc()
    cfg = dataclasses.replace(CATALOG["UR5Reach-v0"],
                              substeps=MPC_PLAN_LOOP["n_substeps"])
    m = core.build_model(cfg)
    H, pop, iters, T = (MPC_PLAN_LOOP[k] for k in ("horizon", "pop",
                                                   "iters", "n_steps"))
    with np.load(os.path.join(OUT, "rollout_UR5Reach.npz")) as z:
        d = {f: z[f"in_{f}"][0] for f in STATE_FIELDS}
    key = jax.random.PRNGKey(10)
    normals = np.stack([np.stack([
        np.asarray(jax.random.normal(ki, (pop, H, cfg.action_dim),
                                     jnp.float32))
        for ki in jax.random.split(kt, iters)])
        for kt in jax.random.split(key, T)])         # (T, iters, pop, H, A)
    out = {f"in_{k}": v for k, v in d.items()}
    for algo in ("mppi", "cem"):
        mcfg = mpc.MPCConfig(horizon=H, pop=pop, iters=iters, algorithm=algo)
        fin, acts, rews, bests = jax.jit(
            lambda s, k: mpc.mpc_rollout(m, mcfg, s, k, T))(_state_of(d), key)
        out.update({f"{algo}_out_{k}": v
                    for k, v in _state_dict(fin).items()})
        out.update({f"{algo}_actions": acts, f"{algo}_rewards": rews,
                    f"{algo}_bests": bests})
    _save("mpc_plan_loop_UR5Reach", normals=normals, **out,
          **{k: np.int32(v) for k, v in MPC_PLAN_LOOP.items()})


# ---------------------------------------------------------------------------
# the eval (solver/eval.py): family data, costs, pick's phase A, one batch
# ---------------------------------------------------------------------------

PLAY_FAMILIES = ("block", "drawer", "door", "button", "dial")
EVAL_PLAY_IDS = (FLAGSHIP, "pandaPlayAbsRPY1Obj-v0")
PICK_ID = "pandaPick-v0"
# eval_family on JAX's draws at a size the CPU runs in seconds; pop 64
# because JAX's reference backend takes n_envs * pop in whole 128-lane
# blocks (solver/mpc.py:374-375)
EVAL_BATCH = dict(n_envs=2, pop=64, horizon=2, iters=1, n_substeps=1,
                  n_steps=3, seed=0)
EVAL_BATCH_FAMILY = "block"
# eval_pick's phase A on pandaPick, 4 envs: the seed whose 70 steps visit
# every phase 0-5 and a retry (found by make_eval_pick_acquire's search)
PICK_ACQUIRE = dict(n_envs=4, acquire_budget=70, seed=3)
ACQ_KEYS = ("phase", "close_ctr", "lift_ctr", "z_at_test", "retried",
            "hold_pos", "bias", "ee", "blk", "a", "t")


def _eval():
    from roboticsplayroompybullet_tpu.solver import eval as E
    return E


def _reset_ags(cfg, rs, n):
    """(n, 11) play achieved goals spread over the reset range: blocks on
    the table in the object range, door on both sides, dial both sides of
    0.5, the button part-way up its spring."""
    lo = np.asarray(cfg.obj_lower_bound, np.float32)
    hi = np.asarray(cfg.obj_upper_bound, np.float32)
    ag = np.zeros((n, cfg.ag_dim), np.float32)
    ag[:, 0:3] = rs.uniform(lo, hi, (n, 3))
    qt = rs.standard_normal((n, 4))
    ag[:, 3:7] = qt / np.linalg.norm(qt, axis=-1, keepdims=True)
    ag[:, 7] = rs.uniform(-0.22, 0.05, n)
    ag[:, 8] = rs.uniform(-0.15, 0.15, n)
    ag[:, 9] = rs.uniform(0.0, 0.03, n)
    ag[:, 10] = rs.uniform(0.0, 1.0, n)
    if n > 2:
        ag[0, 8], ag[1, 8], ag[2, 10] = 0.0, -0.0, 0.5       # the ties
    return ag


def make_eval_data():
    """solver/eval.py's host-side pieces on numpy inputs: family_goals for
    the five play families on both play models (and on a cfg whose object
    range lies within 0.10 of every block, where the 100-draw loop keeps
    its last draw), family_site_params, pick_params, the two family costs
    vmapped over (env, candidate) as make_batched_fused_mpc_step calls
    them, _success on both branches, and pick's rest orientation rpy0."""
    E = _eval()
    from roboticsplayroompybullet_tpu.ops import kinematics as K
    from roboticsplayroompybullet_tpu.ops import spatial as sp
    out = {}
    rs = np.random.RandomState(40)
    narrow = dataclasses.replace(CATALOG[FLAGSHIP],
                                 obj_lower_bound=(0.0, 0.1, 0.05),
                                 obj_upper_bound=(0.06, 0.16, 0.1))
    for name, cfg in (("UR5PlayAbsRPY1Obj", CATALOG[FLAGSHIP]),
                      ("pandaPlayAbsRPY1Obj",
                       CATALOG["pandaPlayAbsRPY1Obj-v0"]),
                      ("narrow", narrow)):
        ags = _reset_ags(cfg, rs, 16)
        if name == "narrow":
            ags[:, 0:2] = (0.03, 0.13)
        out[f"goals_{name}_ags"] = ags
        for fam in PLAY_FAMILIES if name != "narrow" else ("block",):
            rng = np.random.default_rng(41)
            out[f"goals_{name}_{fam}"] = E.family_goals(cfg, ags, fam, rng)
    for env_id in EVAL_PLAY_IDS:
        m = core.build_model(CATALOG[env_id])
        for fam in PLAY_FAMILIES:
            for k, v in E.family_site_params(m, fam, reach_w=0.7).items():
                out[f"site_{_key(env_id)}_{fam}_{k}"] = v

    # the play cost: three cases of two envs with different families
    # (block's with push_w != 0 once), E envs x pop candidates x H steps
    E_, pop, H = 2, 8, 3
    m = core.build_model(CATALOG[FLAGSHIP])
    cfg, nag = m.cfg, m.cfg.ag_dim
    for c, fams in enumerate((("drawer", "block"), ("door", "button"),
                              ("dial", "block"))):
        ps = [E.family_site_params(m, f) for f in fams]
        if c == 0:
            ps[1]["push_w"] = np.float32(0.05)
        p = {k: np.stack([pi[k] for pi in ps]) for k in ps[0]}
        g = _reset_ags(cfg, rs, E_)
        ags = (g[:, None, None] + rs.uniform(-0.05, 0.05, (E_, pop, H, nag))
               ).astype(np.float32)
        ee = (ags[..., 0:3] + rs.uniform(-0.2, 0.2, (E_, pop, H, 3))
              ).astype(np.float32)
        ags = np.concatenate([ags, ee], -1)
        acts = rs.uniform(-1, 1, (E_, pop, H, cfg.action_dim)
                          ).astype(np.float32)
        fn = E.make_play_cost(m)
        cost = jax.vmap(lambda a, g1, u, p1: jax.vmap(
            lambda a1, u1: fn(a1, g1, u1, p1))(a, u))(
            jnp.asarray(ags), jnp.asarray(g), jnp.asarray(acts),
            {k: jnp.asarray(v) for k, v in p.items()})
        out.update({f"play{c}_ags": ags, f"play{c}_goal": g,
                    f"play{c}_acts": acts, f"play{c}_cost": cost})
        out.update({f"play{c}_p_{k}": v for k, v in p.items()})

    # the pick cost: ee offsets from the grasp point straddling `near`
    m = core.build_model(CATALOG[PICK_ID])
    for c, ps in enumerate(((E.pick_params(), E.pick_params(
            reach_w=0.3, grasp_w=1.0, near=0.25)),
            (E.pick_params(open_w=0.5, near=0.06),
             E.pick_params(grasp_z=0.02, goal_w=(1.0, 2.0, 0.5))))):
        p = {k: np.stack([pi[k] for pi in ps]) for k in ps[0]}
        g = rs.uniform(-0.15, 0.15, (E_, 3)).astype(np.float32)
        block = rs.uniform(-0.15, 0.15, (E_, pop, H, 3)).astype(np.float32)
        d = rs.standard_normal((E_, pop, H, 3))
        d *= (rs.uniform(0.0, 2.0, (E_, pop, H, 1)) * p["near"][:, None,
                                                                None, None]
              / np.linalg.norm(d, axis=-1, keepdims=True))
        ee = (block + np.array([0, 0, 1.0]) * p["grasp_z"][:, None, None,
                                                           None] + d)
        ags = np.concatenate([block, ee.astype(np.float32)], -1)
        acts = rs.uniform(-1, 1, (E_, pop, H, m.cfg.action_dim)
                          ).astype(np.float32)
        fn = E.make_pick_cost(m)
        cost = jax.vmap(lambda a, g1, u, p1: jax.vmap(
            lambda a1, u1: fn(a1, g1, u1, p1))(a, u))(
            jnp.asarray(ags), jnp.asarray(g), jnp.asarray(acts),
            {k: jnp.asarray(v) for k, v in p.items()})
        out.update({f"pick{c}_ags": ags, f"pick{c}_goal": g,
                    f"pick{c}_acts": acts, f"pick{c}_cost": cost})
        out.update({f"pick{c}_p_{k}": v for k, v in p.items()})

    # _success: the play branch (any reward >= 0) and the reach branch
    T, n = 6, 8
    rews = np.where(rs.uniform(0, 1, (T, n)) < 0.1, 0.0, -1.0
                    ).astype(np.float32)
    rews[:, 0] = -1.0
    out["succ_play_rs"] = rews
    out["succ_play"] = E._success(CATALOG[FLAGSHIP], "block", rews, None,
                                  None)
    goals = rs.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    ags = (goals[None] + rs.standard_normal((T, n, 3))
           * np.linspace(0.01, 0.1, n)[:, None]).astype(np.float32)
    out.update(succ_reach_ags=ags, succ_reach_goals=goals,
               succ_reach=E._success(CATALOG["UR5Reach-v0"], "reach",
                                     None, ags, goals))
    # rpy0 as eval_pick computes it (eval.py:397-401)
    rest = np.zeros(m.tree.n_dof, np.float32)
    rest[:m.arm.n_arm] = np.asarray(m.arm.rest_pose, np.float32)
    _, q0 = K.fk_site(m.tree, jnp.asarray(rest), m.arm.ee_site)
    out["rpy0_pandaPick"] = np.asarray(sp.quat_to_euler(q0))
    _save("eval_data", **out)


def _acquire_run(E, m, seed, n_envs, budget):
    """JAX's eval_pick phase A on `m` (n_steps=0: no carry step, so the
    planner is never built), recording each step: the wrapper of
    core.step_physics_only (looked up at call time, eval.py:386) passes
    each env's action through a host callback before the physics uses it
    (an identity pure_callback, so the step waits for it), and the
    callback reads the controller's variables from eval_pick's frame on
    the main thread, which waits at the step's read (eval.py:500).
    Returns the per-step records, each with the reset goals."""
    import threading
    step = core.step_physics_only
    main = threading.main_thread().ident
    rec = []

    def snap(action):
        action = np.array(action, copy=True)
        f = sys._current_frames()[main]
        while f.f_code is not E.eval_pick.__code__:
            f = f.f_back
        loc = f.f_locals
        if rec and rec[-1]["t"] == loc["t"]:
            rec[-1]["calls"].append(action)
            return action
        r = {k: np.array(loc[k], copy=True) for k in ACQ_KEYS}
        r.update(calls=[action], goals=np.array(loc["goals"], copy=True))
        rec.append(r)
        return action

    def recorded(m_, state, action):
        action = jax.pure_callback(
            snap, jax.ShapeDtypeStruct(action.shape, action.dtype), action,
            vmap_method="sequential")
        return step(m_, state, action)

    core.step_physics_only = recorded
    try:
        mpc = E.MPCConfig(horizon=10, pop=128, iters=1, algorithm="mppi",
                          sigma_init=0.3)
        E.eval_pick(m, mpc, n_episodes=n_envs, n_envs=n_envs, n_steps=0,
                    seed=seed, backend="reference", acquire_budget=budget)
    finally:
        core.step_physics_only = step
    for r in rec:
        # the callback ran once per env (vmap) with that env's action
        assert np.array_equal(np.stack(r.pop("calls")), r["a"]), r["t"]
    return rec


def make_eval_pick_acquire():
    """eval_pick's scripted grasp acquisition (phase A) on pandaPick,
    PICK_ACQUIRE's 4 envs and 70-step budget: per step the ee and block
    the controller read, its actions, and its variables after the step's
    transition and bias update. `--only eval_pick_acquire` with
    PLAYROOM_SEARCH=N first tries seeds 0..N-1 for one whose run visits
    every phase and a retry."""
    E = _eval()
    m = core.build_model(CATALOG[PICK_ID])
    n, budget = PICK_ACQUIRE["n_envs"], PICK_ACQUIRE["acquire_budget"]

    def covers(rec):
        seen = set(np.concatenate([r["phase"] for r in rec]).tolist())
        return seen >= set(range(6)) and bool(rec[-1]["retried"].any())

    seed = PICK_ACQUIRE["seed"]
    for s in range(int(os.environ.get("PLAYROOM_SEARCH", "0"))):
        t0 = time.time()
        rec = _acquire_run(E, m, s, n, budget)
        phases = np.stack([r["phase"] for r in rec])
        print(f"seed {s}: {len(rec)} steps, phases seen "
              f"{sorted(set(phases.ravel().tolist()))}, retried "
              f"{rec[-1]['retried'].tolist()} ({time.time() - t0:.1f} s)",
              flush=True)
        if covers(rec):
            seed = s
            break
    rec = _acquire_run(E, m, seed, n, budget)
    assert covers(rec), "seed does not visit every phase and a retry"
    out = {k: np.stack([r[k] for r in rec]) for k in ACQ_KEYS}
    _save("eval_pick_acquire", goals=rec[0]["goals"], seed=np.int32(seed),
          **{k: np.int32(v) for k, v in PICK_ACQUIRE.items() if k != "seed"},
          **out)


def make_eval_family_batch():
    """One eval_family batch of JAX's (EVAL_BATCH on the flagship,
    EVAL_BATCH_FAMILY, backend="reference"), through a step_fn wrapper that
    records each control step's states, plans, rewards and ags. The first
    step's input states are the reset states with the family goals; the
    normals each step's iteration drew are rebuilt from its key as
    make_batched_fused_mpc_step splits it (solver/mpc.py:411-426)."""
    E = _eval()
    sol, mpc = _mpc()
    m = core.build_model(CATALOG[FLAGSHIP])
    c = EVAL_BATCH
    cfg = mpc.MPCConfig(horizon=c["horizon"], pop=c["pop"],
                        iters=c["iters"], algorithm="mppi", sigma_init=0.3)
    inner = jax.jit(mpc.make_batched_fused_mpc_step(
        m, cfg, c["n_envs"], backend="reference", n_substeps=c["n_substeps"],
        cost_fn=E.make_play_cost(m), with_ee=True))
    calls = []

    def step_fn(states, plans, key, params):
        out = inner(states, plans, key, params)
        calls.append((states, plans, key, out))
        return out

    res = E.eval_family(m, cfg, EVAL_BATCH_FAMILY, n_episodes=c["n_envs"],
                        n_envs=c["n_envs"], n_steps=c["n_steps"],
                        seed=c["seed"], backend="reference",
                        n_substeps=c["n_substeps"], step_fn=step_fn)
    A = m.cfg.action_dim
    normals = np.stack([np.stack([np.stack([
        np.asarray(jax.random.normal(kk, (c["pop"], c["horizon"], A),
                                     jnp.float32))
        for kk in jax.random.split(k, c["n_envs"])])
        for k in jax.random.split(key, c["iters"])])
        for _, _, key, _ in calls])           # (T, iters, E, pop, H, A)
    st0, pl0 = calls[0][0], calls[0][1]
    out = {f"in_{k}": v for k, v in _state_dict(st0).items()}
    fin = _state_dict(calls[-1][3][0])
    out.update({f"out_{k}": v for k, v in fin.items()})
    _save(f"eval_family_{_key(FLAGSHIP)}", normals=normals,
          plan_mean=pl0.mean, plan_sigma=pl0.sigma,
          rewards=np.stack([np.asarray(o[2]) for *_, o in calls]),
          ags=np.stack([np.asarray(o[3]) for *_, o in calls]),
          n_success=np.int32(res["n_success"]),
          success_rate=np.float32(res["success_rate"]),
          family=np.array(EVAL_BATCH_FAMILY),
          **{k: np.int32(v) for k, v in c.items()}, **out)


def jobs() -> dict:
    out = {f"reset_{_key(FLAGSHIP)}": flagship_reset,
           f"step12_{_key(FLAGSHIP)}": make_step12, "rewards": make_rewards,
           "mpc_cost": make_mpc_cost, "mpc_init": make_mpc_init,
           "mpc_sample": make_mpc_sample, "mpc_update": make_mpc_update,
           f"mpc_step_{_key(FLAGSHIP)}": make_mpc_step,
           "mpc_loop_UR5Reach": make_mpc_loop,
           "mpc_plan_loop_UR5Reach": make_mpc_plan_loop,
           "proprio": make_proprio, "eval_data": make_eval_data,
           "eval_pick_acquire": make_eval_pick_acquire,
           f"eval_family_{_key(FLAGSHIP)}": make_eval_family_batch}
    for e in CATALOG:
        out[f"golden_lane_{_key(e)}"] = (lambda e=e: make_golden_lane(e))
    for e in SETTLE_ENVS:
        out[f"settle_{_key(e)}"] = (lambda e=e: make_settle(e))
    for e in SIM3_ENVS:
        out[f"sim3_{_key(e)}"] = (lambda e=e: make_sim3(e))
    for e in CONTROL_ENVS:
        out[f"control_{_key(e)}"] = (lambda e=e: make_control(e))
    for e, H, ns in ROLLOUTS:
        out[f"rollout_{_key(e)}"] = (lambda e=e, H=H, ns=ns:
                                     make_rollout(e, H, ns))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="fixture names to write")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    todo = jobs()
    if args.list:
        print("\n".join(todo))
        return
    names = args.only or list(todo)
    for name in names:
        t0 = time.time()
        todo[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

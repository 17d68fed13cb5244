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
which are a jitted batched_reset (the port has no reset yet), and the MPC
normals, which jax.random draws and the fixture stores. The physics fixtures
are B=128; the MPC ones (mpc_*) are as small as their cases allow.
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
     "roboticsplayroompybullet_tpu/envs/obs.py",
     "roboticsplayroompybullet_tpu/ops/dynamics.py",
     "roboticsplayroompybullet_tpu/ops/spatial.py"]
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


def jobs() -> dict:
    out = {f"reset_{_key(FLAGSHIP)}": flagship_reset,
           f"step12_{_key(FLAGSHIP)}": make_step12, "rewards": make_rewards,
           "mpc_cost": make_mpc_cost, "mpc_init": make_mpc_init,
           "mpc_sample": make_mpc_sample, "mpc_update": make_mpc_update,
           f"mpc_step_{_key(FLAGSHIP)}": make_mpc_step,
           "mpc_loop_UR5Reach": make_mpc_loop}
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

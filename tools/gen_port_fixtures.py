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
The fidelity_* fixtures (tools/check_fused_torch.py, one an id: 4-12 min on
two cores) also run JAX's vmap oracle, the only fixtures that do; the lane
twin's gap figures in them reproduce to rounding across hosts and core
counts, the oracle's outputs bit for bit.
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
# the multi-device fixtures (parallel_*) run JAX's sharded planners on a
# 2-device CPU mesh; one device holds every other fixture's program
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
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
     "roboticsplayroompybullet_tpu/solver/ilqr.py",
     "roboticsplayroompybullet_tpu/solver/gradient.py",
     "roboticsplayroompybullet_tpu/parallel/rollout.py",
     "roboticsplayroompybullet_tpu/envs/obs.py",
     "roboticsplayroompybullet_tpu/ops/dynamics.py",
     "roboticsplayroompybullet_tpu/ops/spatial.py",
     "roboticsplayroompybullet_tpu/ops/kinematics.py",
     "roboticsplayroompybullet_tpu/envs/core.py",
     "roboticsplayroompybullet_tpu/envs/physics.py",
     "roboticsplayroompybullet_tpu/envs/contact_solver.py",
     "roboticsplayroompybullet_tpu/ops/contact.py",
     "roboticsplayroompybullet_tpu/utils/render.py",
     "roboticsplayroompybullet_tpu/envs/wrapper.py",
     "roboticsplayroompybullet_tpu/utils/metrics.py",
     "roboticsplayroompybullet_tpu/parallel/mesh.py",
     "roboticsplayroompybullet_tpu/utils/checkpoint.py",
     "tools/launch_distributed.py"]
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


# ---------------------------------------------------------------------------
# gradient solvers (solver/ilqr.py, solver/gradient.py)
# ---------------------------------------------------------------------------

def _batched(st: EnvState) -> dict:
    """One env's state as a B=1 state dict (batch leading)."""
    return {f: np.asarray(getattr(st, f))[None] for f in STATE_FIELDS}


def _lane_flat_dynamics(m, template):
    """make_flat_dynamics with the JAX lane twin (make_lane_control, then
    make_lane_sim at solve 8: make_reference_step's body) in place of the
    vmap oracle, on one env: the function the port's iLQR differentiates.
    The action is clipped once, inside make_lane_control, as the oracle's
    step_physics_only clips it once (the derivative at a bound is half
    the gradient per clip). Object fields of a 0-object env pass through,
    as the oracle's do."""
    from roboticsplayroompybullet_tpu.solver.ilqr import _extract, _inject
    control = fs.make_lane_control(m.cfg, m.tree, m.arm)
    sim = fs.make_lane_sim(m.cfg, m.tree, m.arm, m.scene, None,
                           solve_iters=8)
    _, NF = fs._field_rows(m.cfg, m.tree)

    def f(x, u):
        s = jax.tree.map(lambda v: v[None], _inject(template, x))
        X3 = fs.pack_state(m.cfg, m.tree, s).reshape(NF, 1, 1)
        st = fs._lanes_from_block(m.cfg, m.tree, X3)
        ctrl, grip = control(st["q"], u[:, None, None])
        X2 = fs._block_from_lanes(m.cfg, m.tree, sim(st, ctrl, grip))
        s2 = fs.unpack_state(m.cfg, m.tree, X2.reshape(NF, 1), s)
        s2 = s2.replace(ctrl_q=ctrl.reshape(1, -1), grip=grip.reshape(1))
        return _extract(jax.tree.map(lambda v: v[0], s2))

    return f


def _pinched_state():
    """tests/test_ilqr.py::test_ilqr_plan_improves_pick_contact's scripted
    pinch on the full 12-substep pandaPick model (PRNGKey 3), with the
    block's reset position and the hold pose's rpy."""
    from roboticsplayroompybullet_tpu.ops import kinematics as K
    from roboticsplayroompybullet_tpu.ops import spatial as sp
    mfull = core.build_model(CATALOG["pandaPick-v0"])
    state, obs = jax.jit(lambda k: core.reset(mfull, k))(
        jax.random.PRNGKey(3))
    step = jax.jit(lambda s, a: core.step(mfull, s, a))
    rest = jnp.zeros(mfull.tree.n_dof, jnp.float32).at[
        :mfull.arm.n_arm].set(jnp.asarray(mfull.arm.rest_pose, jnp.float32))
    _, q0, _ = K.site_pose_and_jacobian(mfull.tree, rest, mfull.arm.ee_site)
    rpy = tuple(float(x) for x in np.asarray(sp.quat_to_euler(q0)))

    def go(st, pos, grip, n):
        a = jnp.asarray([*pos, *rpy, grip], jnp.float32)
        for _ in range(n):
            st, _, _, _ = step(st, a)
        return st

    b = np.asarray(state.obj_pos[0])
    ee0 = np.asarray(obs["controllable_achieved_goal"])[:3]
    st = go(state, (ee0[0], ee0[1], 0.15), -1.0, 20)
    st = go(st, (b[0], b[1], 0.15), -1.0, 25)
    for zt in np.arange(0.12, b[2] + 0.005, -0.03):
        st = go(st, (b[0], b[1], zt), -1.0, 8)
    st = go(st, (b[0], b[1], b[2] + 0.008), -1.0, 20)
    st = go(st, (b[0], b[1], b[2] + 0.008), 1.0, 15)         # pinch
    return st, b, rpy


def _ilqr_imports():
    """(the solver package, its ilqr module: the package's `ilqr` is the
    function)."""
    import importlib
    from roboticsplayroompybullet_tpu import solver as sol
    return sol, importlib.import_module(
        "roboticsplayroompybullet_tpu.solver.ilqr")


def make_ilqr_di():
    """ilqr on test_ilqr_double_integrator's point mass, and its c0."""
    _, il = _ilqr_imports()
    dt = 0.1

    def f(x, u):
        return jnp.stack([x[0] + x[1] * dt, x[1] + u[0] * dt])

    def stage(x, u):
        return 0.1 * (x @ x) + 0.01 * (u @ u)

    def final(x):
        return 100.0 * (x @ x)

    x0 = jnp.array([1.0, 0.0])
    us0 = jnp.zeros((30, 1))
    res = jax.jit(lambda x, u: il.ilqr(f, stage, final, x, u,
                                       il.ILQRConfig(iters=15)))(x0, us0)
    _, c0 = il._rollout_flat(f, stage, final, x0, us0)
    _save("ilqr_di", x0=x0, us0=us0, us=res.us, xs=res.xs, cost=res.cost,
          cost_trace=res.cost_trace, c0=c0)


def _jacfwd(g, x, u):
    """(∂g/∂x, ∂g/∂u) in forward mode, op by op: the matrices JAX's
    iLQR's jacrev gives. XLA took over 25 minutes and ~28 GB to compile
    jacrev of the oracle step here, and over 20 GB for jacfwd of the lane
    twin; op by op the lane twin's takes minutes."""
    with jax.disable_jit():
        return jax.jacfwd(g, argnums=(0, 1))(x, u)


def _fwd_linearised(f):
    """f with a custom VJP from its forward-mode Jacobian: under
    ilqr.py's jacrev it gives the same A_t, B_t as f, and its jitted
    programs compile in minutes (the reverse mode of the oracle's contact
    loops does not)."""
    @jax.custom_vjp
    def g(x, u):
        return f(x, u)

    def fwd(x, u):
        return f(x, u), jax.jacfwd(f, argnums=(0, 1))(x, u)

    def bwd(jac, ct):
        return ct @ jac[0], ct @ jac[1]

    g.defvjp(fwd, bwd)
    return g


def _plan(sol, il, m, state, us0, cfg, w):
    """ilqr_plan (ilqr.py:210-218) line for line, its dynamics
    linearised in forward mode (_fwd_linearised)."""
    f = _fwd_linearised(il.make_flat_dynamics(m, state))
    stage, final = il.make_stage_cost(m, state, w)
    high = jnp.asarray(m.cfg.action_high, jnp.float32)
    return jax.jit(lambda x, u: il.ilqr(f, stage, final, x, u, cfg,
                                        u_low=-high, u_high=high))(
        il._extract(state), us0)


def make_ilqr_reach():
    """test_ilqr_plan_improves_reach's case: UR5Reach at 3 substeps from
    PRNGKey 2; the flat state, the Jacobians of the lane twin and of the
    oracle at (x0, 0), c0 and ilqr_plan H=4 iters=4."""
    sol, il = _ilqr_imports()
    from roboticsplayroompybullet_tpu.solver.cost import CostWeights
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=3))
    state, _ = jax.jit(lambda k: core.reset(m, k))(jax.random.PRNGKey(2))
    us0 = jnp.zeros((4, m.cfg.action_dim))
    f = il.make_flat_dynamics(m, state)
    stage, final = il.make_stage_cost(m, state)
    x0 = il._extract(state)
    _, c0 = il._rollout_flat(f, stage, final, x0, us0)
    lane = _lane_flat_dynamics(m, state)
    A_o, B_o = _jacfwd(f, x0, us0[0])
    A_l, B_l = _jacfwd(lane, x0, us0[0])
    res = _plan(sol, il, m, state, us0, sol.ILQRConfig(iters=4),
                CostWeights())
    _save("ilqr_reach", x0=x0, us0=us0, x1_oracle=jax.jit(f)(x0, us0[0]),
          x1_lane=jax.jit(lane)(x0, us0[0]), A_oracle=A_o, B_oracle=B_o,
          A_lane=A_l, B_lane=B_l, c0=c0, us=res.us, xs=res.xs,
          cost=res.cost, cost_trace=res.cost_trace, substeps=np.int32(3),
          **_batched(state))


def make_ilqr_pinch():
    """test_ilqr_plan_improves_pick_contact's case: the pinch scripted on
    the full model, planned at 2 substeps from the hold plan (H=3) with
    the goal-only cost; the flat state, the lane twin's Jacobians at
    (x0, us0[0]), c0, d cost / d (x0, us) (forward mode) and ilqr_plan
    iters=3."""
    sol, il = _ilqr_imports()
    from roboticsplayroompybullet_tpu.solver.cost import CostWeights
    st, b, rpy = _pinched_state()
    m = core.build_model(dataclasses.replace(
        CATALOG["pandaPick-v0"], substeps=2))
    H = 3
    hold = jnp.asarray([b[0], b[1], b[2] + 0.10, *rpy, 1.0], jnp.float32)
    us0 = jnp.tile(hold[None], (H, 1))
    w = CostWeights(action=0.0)
    f = il.make_flat_dynamics(m, st)
    stage, final = il.make_stage_cost(m, st, w)
    x0 = il._extract(st)
    _, c0 = il._rollout_flat(f, stage, final, x0, us0)
    gx, gu = jax.jit(jax.jacfwd(
        lambda x, u: il._rollout_flat(f, stage, final, x, u)[1],
        argnums=(0, 1)))(x0, us0)
    lane = _lane_flat_dynamics(m, st)
    A_l, B_l = _jacfwd(lane, x0, us0[0])
    res = _plan(sol, il, m, st, us0, sol.ILQRConfig(iters=3), w)
    _save("ilqr_pinch", x0=x0, us0=us0, x1_lane=jax.jit(lane)(x0, us0[0]),
          x1_oracle=jax.jit(f)(x0, us0[0]), A_lane=A_l, B_lane=B_l, c0=c0,
          gx=gx, gu=gu, us=res.us, xs=res.xs, cost=res.cost,
          cost_trace=res.cost_trace, substeps=np.int32(2), **_batched(st))


def make_ilqr_refine():
    """test_gradient_refine_improves_reach's case, its code as there:
    refine on UR5Reach at 3 substeps from PRNGKey 5, H=4, 12 iterations
    at lr 0.1."""
    sol, _ = _ilqr_imports()
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=3))
    state, _ = jax.jit(lambda k: core.reset(m, k))(jax.random.PRNGKey(5))
    us0 = jnp.zeros((4, m.cfg.action_dim))
    cfg = sol.GradConfig(iters=12, lr=0.1)
    a, trace = jax.jit(lambda s, u: sol.refine(m, s, u, cfg))(state, us0)
    _save("ilqr_refine", us0=us0, actions=a, trace=trace, lr=np.float32(0.1),
          substeps=np.int32(3), **_batched(state))


# ---------------------------------------------------------------------------
# the multi-device layer (parallel/mesh.py, solver/mpc.py's sharded planners,
# tools/launch_distributed.py)
# ---------------------------------------------------------------------------

N_SHARDS = 2
# make_sharded_fused_planner as tests/test_parallel.py and the dryrun call it
PAR_FUSED = dict(pop=256, horizon=2, iters=2, n_substeps=2,
                 preview_ik_iters=2, preview_solve_iters=4)
# make_sharded_planner, scored by the oracle step at 2 substeps
PAR_PLAN = dict(pop=4, horizon=2, iters=2, substeps=2)
LAUNCH = dict(steps=1, pop=128, horizon=2, iters=1, seed=0)


def _par_meshes() -> dict:
    """JAX's two 2-device meshes: 1-D ("env",) and 2x1 ("dcn", "env")."""
    from roboticsplayroompybullet_tpu import parallel as par
    devs = jax.devices()[:N_SHARDS]
    assert len(devs) == N_SHARDS, "needs 2 CPU devices (XLA_FLAGS)"
    return {"env": par.make_mesh(n_devices=N_SHARDS, devices=devs),
            "dcn_env": par.make_mesh(n_devices=N_SHARDS, n_hosts=N_SHARDS,
                                     devices=devs)}


def _shard_normals(key, pop: int, H: int, A: int, iters: int) -> np.ndarray:
    """(iters, pop, H, A): iteration j's normals of every shard, shard i's
    rows i·pop/N onwards, as each shard draws them (its key folded with
    its linear mesh index, split into `iters` keys: mpc.py:279-288,
    :106)."""
    n = pop // N_SHARDS
    keys = [jax.random.split(jax.random.fold_in(key, i), iters)
            for i in range(N_SHARDS)]
    return np.stack([np.concatenate([
        np.asarray(jax.random.normal(keys[i][j], (n, H, A), jnp.float32))
        for i in range(N_SHARDS)]) for j in range(iters)])


def _reach_start() -> dict:
    with np.load(os.path.join(OUT, "rollout_UR5Reach.npz")) as z:
        return {f: z[f"in_{f}"][0] for f in STATE_FIELDS}


def _par_planner_runs(make, m, cfg_kw, key, algos) -> dict:
    """plan and best of make(m, MPCConfig, mesh) from init_plan, by each
    of algos, on each mesh."""
    sol, mpc = _mpc()
    d, out = _reach_start(), {}
    for mesh_name, mesh in _par_meshes().items():
        for algo in algos:
            cfg = mpc.MPCConfig(algorithm=algo, **cfg_kw)
            pl, best = make(m, cfg, mesh)(_state_of(d), sol.init_plan(m, cfg),
                                          key)
            out.update({f"{mesh_name}_{algo}_mean": pl.mean,
                        f"{mesh_name}_{algo}_sigma": pl.sigma,
                        f"{mesh_name}_{algo}_best": best})
    out.update({f"in_{k}": v for k, v in d.items()})
    return out


def make_parallel_fused():
    """JAX's make_sharded_fused_planner (backend="reference", the plain
    lane twin) on UR5Reach at PAR_FUSED's size, 128 candidates a shard,
    from the first start state of rollout_UR5Reach; the shards' normals
    are stored."""
    sol, _ = _mpc()
    m = core.build_model(CATALOG["UR5Reach-v0"])
    kw = {k: v for k, v in PAR_FUSED.items() if k != "n_substeps"}
    key = jax.random.PRNGKey(11)

    def make(m, cfg, mesh):
        return sol.make_sharded_fused_planner(
            m, cfg, mesh, block_envs=PAR_FUSED["pop"] // N_SHARDS,
            backend="reference", n_substeps=PAR_FUSED["n_substeps"])

    out = _par_planner_runs(make, m, kw, key, ("mppi", "cem"))
    _save("parallel_fused_UR5Reach", **out,
          normals=_shard_normals(key, kw["pop"], kw["horizon"],
                                 m.cfg.action_dim, kw["iters"]),
          **{k: np.int32(v) for k, v in PAR_FUSED.items()})


def make_parallel_plan():
    """JAX's make_sharded_planner (each shard scoring through vmapped
    core.step_physics_only) on UR5Reach at PAR_PLAN's size, by CEM (the
    dryrun's algorithm; MPPI's reductions are the fused planner's), from
    the first start state of rollout_UR5Reach; the shards' normals are
    stored."""
    sol, _ = _mpc()
    m = core.build_model(dataclasses.replace(
        CATALOG["UR5Reach-v0"], substeps=PAR_PLAN["substeps"]))
    kw = {k: v for k, v in PAR_PLAN.items() if k != "substeps"}
    key = jax.random.PRNGKey(12)
    out = _par_planner_runs(sol.make_sharded_planner, m, kw, key, ("cem",))
    _save("parallel_plan_UR5Reach", **out,
          normals=_shard_normals(key, kw["pop"], kw["horizon"],
                                 m.cfg.action_dim, kw["iters"]),
          **{k: np.int32(v) for k, v in PAR_PLAN.items()})


def make_launch_ckpt():
    """The checkpoint tools/launch_distributed.py writes after LAUNCH's
    one dryrun step on UR5Reach (one CPU device), byte for byte."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import launch_distributed as ld
    path = os.path.join(ROOT, "build", "launch_ckpt_fixture.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    L = LAUNCH
    ld.run_loop(ld.parse_args([
        "--steps", str(L["steps"]), "--ckpt", path, "--ckpt-every", "1",
        "--pop", str(L["pop"]), "--horizon", str(L["horizon"]),
        "--iters", str(L["iters"]), "--devices", "1", "--block-envs",
        str(L["pop"]), "--seed", str(L["seed"]), "--dryrun", "--env",
        "UR5Reach-v0"]))
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    _save("launch_ckpt_UR5Reach", ckpt=raw,
          **{k: np.int32(v) for k, v in L.items()})


# the gradient solvers' jobs, on tests/test_ilqr.py's cases
ILQR_JOBS = {"ilqr_di": make_ilqr_di, "ilqr_reach": make_ilqr_reach,
             "ilqr_pinch": make_ilqr_pinch, "ilqr_refine": make_ilqr_refine}


RENDER_PX = 48          # tests/test_utils.py's render size


def _batched_state(st: EnvState) -> dict:
    """One env's state as B=1 arrays (batch leading, the port's layout)."""
    return {k: v[None] for k, v in _state_dict(st).items()}


def _ghost_arrays(prefix: str, spheres, boxes) -> dict:
    names = ("pos", "rad", "col", "alp")
    out = {f"{prefix}_g_{n}": np.asarray(a) for n, a in zip(names, spheres)}
    names = ("pos", "quat", "half", "col", "alp")
    out.update({f"{prefix}_gb_{n}": np.asarray(a)
                for n, a in zip(names, boxes)})
    return out


def make_render_camera():
    """The camera path (utils/render.py, the camera half of
    envs/wrapper.py) and utils/metrics.py on small cases:
      * render_state at 48 px of pandaPick's reset(PRNGKey(0)) state, plain,
        with one ghost sphere and with that ghost at alpha 0
        (tests/test_utils.py's cases), and its wrist_camera frame;
      * UR5Reach's reset(PRNGKey(0)) state, goal [0, 0.1, 0.1], with and
        without show_goal;
      * the flagship (the reset dump's env 0) at 200 px, plain and with
        PlayEnv._sub_goal_ghosts of a full_positional_state sub-goal (env
        1's), and the ghosts of achieved_goal sub-goals on
        pandaPlayAbsRPY1Obj (a unit and a zero block quaternion) and
        pandaPick (a non-play env), and of a controllable_achieved_goal
        sub-goal on UR5Reach;
      * write_png's bytes for a uint8 and an out-of-range float image;
      * play_element_bits on the flagship and pandaPlay, thresholds hit
        exactly and missed by one float32 step."""
    import tempfile
    from roboticsplayroompybullet_tpu.envs import wrapper
    from roboticsplayroompybullet_tpu.utils import metrics as met
    from roboticsplayroompybullet_tpu.utils import render as rnd
    out = {}

    def render(m, st, **kw):
        return np.asarray(rnd.render_state(m.cfg, m.tree, m.arm, m.scene,
                                           st, **kw))

    m = core.build_model(CATALOG["pandaPick-v0"])
    st, _ = jax.jit(lambda k: core.reset(m, k))(jax.random.PRNGKey(0))
    out.update({f"pick_{k}": v for k, v in _batched_state(st).items()})
    ghosts = (np.array([[0.0, 0.1, 0.05]], np.float32),
              np.array([0.08], np.float32),
              np.array([[1.0, 0.0, 1.0]], np.float32),
              np.array([0.5], np.float32))
    out["pick_plain"] = render(m, st, pixels=RENDER_PX)
    out["pick_ghost"] = render(m, st, pixels=RENDER_PX,
                               ghosts=tuple(map(jnp.asarray, ghosts)))
    ghosts0 = ghosts[:3] + (np.zeros(1, np.float32),)
    out["pick_ghost0"] = render(m, st, pixels=RENDER_PX,
                                ghosts=tuple(map(jnp.asarray, ghosts0)))
    out.update({f"pick_ghost_{n}": a for n, a in zip(
        ("pos", "rad", "col", "alp"), ghosts)})
    out["pick_wrist"] = render(m, st, pixels=RENDER_PX,
                               camera=rnd.wrist_camera(m.tree, m.arm, st))

    env = wrapper.PlayEnv(CATALOG["pandaPick-v0"])
    ag = np.array([0.05, 0.12, 0.02], np.float32)
    env.visualise_sub_goal(ag, "achieved_goal")
    out["pick_ag"] = ag
    out.update(_ghost_arrays("pick_ag", *env._sub_goal_ghosts()))

    cfg = CATALOG["UR5Reach-v0"]
    m = core.build_model(cfg)
    st, obs = jax.jit(lambda k: core.reset(m, k))(jax.random.PRNGKey(0))
    st = st.replace(goal=jnp.array([0.0, 0.1, 0.1], jnp.float32))
    out.update({f"reach_{k}": v for k, v in _batched_state(st).items()})
    out["reach_goal_on"] = render(m, st, pixels=RENDER_PX)
    m_off = core.build_model(dataclasses.replace(cfg, show_goal=False))
    out["reach_goal_off"] = render(m_off, st, pixels=RENDER_PX)
    env = wrapper.PlayEnv(cfg)
    cag = np.asarray(obs["controllable_achieved_goal"]) + np.array(
        [0.03, -0.02, 0.02, 0.0], np.float32)
    env.visualise_sub_goal(cag, "controllable_achieved_goal")
    out["reach_cag"] = cag
    out.update(_ghost_arrays("reach_cag", *env._sub_goal_ghosts()))

    m = core.build_model(CATALOG[FLAGSHIP])
    d = flagship_reset()
    st = _state_of({k: v[0] for k, v in d.items()})
    out.update({f"flag_{k}": v[:1] for k, v in d.items()})
    sub = np.asarray(_obs_fn(m)(_state_of({k: v[1] for k, v in d.items()}))
                     ["full_positional_state"])
    env = wrapper.PlayEnv(CATALOG[FLAGSHIP])
    env.visualise_sub_goal(sub, "full_positional_state")
    g, gb = env._sub_goal_ghosts()
    out["flag_sub_goal"] = sub
    out.update(_ghost_arrays("flag", g, gb))
    frame = jax.jit(lambda s, g, gb: rnd.render_state(
        m.cfg, m.tree, m.arm, m.scene, s, ghosts=g, ghost_boxes=gb))
    out["flag_ghost"] = np.asarray(frame(st, g, gb))
    env.delete_sub_goal()
    out["flag_plain"] = np.asarray(frame(st, *env._sub_goal_ghosts()))

    env = wrapper.PlayEnv(CATALOG["pandaPlayAbsRPY1Obj-v0"])
    art = [0.1, 0.5, 0.02, 0.4]
    for name, quat in (("unit", [0.2, 0.4, 0.6, 1.8]),
                       ("zero", [0.0, 0.0, 0.0, 0.0])):
        ag = np.array([0.05, 0.1, 0.0] + quat + art, np.float32)
        env.visualise_sub_goal(ag, "achieved_goal")
        out[f"pplay_{name}_ag"] = ag
        out.update(_ghost_arrays(f"pplay_{name}", *env._sub_goal_ghosts()))

    u8 = (out["pick_plain"] * 255).astype(np.uint8)
    f32 = out["pick_plain"] * 1.3 - 0.1
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in (("u8", u8), ("f32", f32)):
            path = os.path.join(tmp, name + ".png")
            rnd.write_png(path, img)
            with open(path, "rb") as f:
                out[f"png_{name}"] = np.frombuffer(f.read(), np.uint8)
            out[f"png_{name}_img"] = img

    rs = np.random.RandomState(40)
    thr = {"pos": 0.05, "drawer": 0.025, "door": 0.04, "button": 0.01,
           "dial": 0.3}
    for env_id, tag in ((FLAGSHIP, "bits_flag"), ("pandaPlay-v0",
                                                  "bits_pplay")):
        cfg = CATALOG[env_id]
        n_obj = cfg.num_objects
        ident = np.array([0, 0, 0, 1], np.float32)
        ag = np.concatenate([np.concatenate([rs.uniform(-0.3, 0.3, 3),
                                             ident]) for _ in range(n_obj)]
                            + [rs.uniform(0, 0.5, 4)]).astype(np.float32)
        ags = np.repeat(ag[None], 32, 0)
        ags[:16] = 0.0                      # exact hits from zero
        ags[:16, 3:7] = ident
        goals = ags.copy()
        k = 7 * n_obj
        for i, (name, t) in enumerate(thr.items()):
            t32 = np.float32(t)
            up = np.nextafter(t32, np.float32(1))
            col = [0, k, k + 1, k + 2, k + 3][i]
            goals[2 * i, col] = t32         # hit exactly
            goals[2 * i + 1, col] = -up     # missed by one step
        for r, ang in ((10, 0.78), (11, 0.79)):        # pi/4 = 0.7854
            goals[r, 3:7] = [0, 0, np.sin(ang / 2), np.cos(ang / 2)]
        goals[16:] += rs.normal(0, 0.04, goals[16:].shape).astype(np.float32)
        goals[16:, 3:7] *= 1.7                          # unnormalised
        bits = met.play_element_bits(cfg, jnp.asarray(ags),
                                     jnp.asarray(goals))
        out[f"{tag}_ag"], out[f"{tag}_g"] = ags, goals
        out.update({f"{tag}_{n}": np.asarray(b) for n, b in bits.items()})
    _save("render_camera", **out)


# ---------------------------------------------------------------------------
# the full-fidelity sweep (tools/check_fused_torch.py): the vmap oracle
# ---------------------------------------------------------------------------

FIDELITY_B = 64
# the contact-row families, by the row kinds of the port's
# cuda_build.row_table: block vs floor and statics, block vs block, block vs
# an articulated element, pad vs block, pad vs floor and statics, pad vs an
# articulated element
FAMILIES = ("block_world", "block_block", "block_art", "pad_block",
            "pad_world", "pad_art")
CONTACT_ENVS = 16       # the last envs of a fixture, placed in contact
PEN = 2e-3              # depth of a placed contact (m)


def row_family(bd) -> str:
    """The family of one of gather_bundles' bundles, by its body indices."""
    if bd.a >= 0 and bd.b >= 0:
        return "block_block"
    if bd.k >= 0:
        return "block_art" if bd.a >= 0 else "pad_art"
    if bd.g >= 0:
        return "pad_block" if bd.a >= 0 else "pad_world"
    return "block_world"


def contact_rows(m, d: dict) -> dict:
    """{family: (rows, active rows)} of JAX's lane gather_bundles at the
    positions of the states d (batch leading): a row is active where its
    depth is positive, as lane_solve activates it."""
    cfg, tree, arm, scene = m.cfg, m.tree, m.arm, m.scene
    X = fs.pack_state(cfg, tree, _state_of(d))
    st = fs._lanes_from_block(cfg, tree, X[:, None])
    kin = fs.lane_fk_vel(tree, st["q"], st["qd"])
    pads = fs.lane_pad_kinematics(tree, arm, kin)
    bundles, _ = fs.gather_bundles(cfg, tree, arm, scene, st, kin, st["qd"],
                                   *pads)
    out = {}
    for bd in bundles:
        rows, act = out.get(row_family(bd), (0, 0))
        dep = np.asarray(bd.depth)
        out[row_family(bd)] = (rows + dep.size, act + int((dep > 0).sum()))
    return out


def _rot(q) -> np.ndarray:
    """3x3 rotation matrix of a quaternion (x, y, z, w), in float64."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _art_boxes(scene, k: int, art_q: float):
    """(center, quat, half) of element k's real boxes at joint value art_q,
    placed as physics.art_box_pose places the element's frame."""
    from roboticsplayroompybullet_tpu.envs import physics
    aq = jnp.zeros(4, jnp.float32).at[k].set(art_q)
    pos, quat = (np.asarray(v, np.float64)
                 for v in physics.art_box_pose(scene, k, aq))
    return [(pos + _rot(quat) @ np.asarray(scene.art_boxes_pos[k, b]),
             quat, np.asarray(scene.art_boxes_half[k, b], np.float64))
            for b in fs._real_boxes(scene, k)]


def _top(center, quat, half) -> float:
    """World z of a box's highest point."""
    return float(center[2] + np.abs(_rot(quat)[2]) @ half)


def _pad0(m, q):
    """(pad 0's center, the end effector's position and quat) at q (n, N)."""
    tree, arm = m.tree, m.arm
    kin = fs.lane_fk_vel(tree, q, jnp.zeros_like(q))
    pad0 = fs.lane_pad_kinematics(tree, arm, kin)[0][0]
    pos_l, quat_l = fs.lane_fk_links(tree, q)
    ee, eq = fs._lane_site_pose(tree, pos_l, quat_l, arm.ee_site)
    return pad0, ee, eq


def _pad_ik(m, q, targets):
    """q (n, N) with pad 0's center moved to targets (3, N): JAX's lane DLS
    IK moves the end effector by pad 0's remaining miss, its orientation
    held, a few rounds."""
    iters = 16 if m.arm.name == "Panda" else 24
    q = jnp.asarray(q)
    _, _, quat = _pad0(m, q)
    for _ in range(4):
        pad0, ee, _ = _pad0(m, q)
        q = fs.lane_ik_dls(m.tree, m.arm, q, ee + (targets - pad0), quat,
                           iters)
    return np.asarray(q)


def place_contacts(m, d: dict, seed: int) -> dict:
    """The last CONTACT_ENVS envs of d moved into contact, one placement
    each, in turn over what the model has: a block under pad 0 (pad vs
    block; pad 0 presses on the block from above, the gripper does not
    hold it), a block in each articulated element wide enough to hold it
    (block vs element), pad 0 on each element's highest box (pad vs
    element), and pad 0 on the table, or on the floor where the scene has
    no table (pad vs world). The start states leave the pad and element
    families with no active row (the arm rests above the scene), so without
    these placements their rows would be compared while idle. Velocities,
    servo-target offsets and gripper commands stay as drawn."""
    cfg, tree, arm, scene = m.cfg, m.tree, m.arm, m.scene
    rs = np.random.RandomState(seed)
    d = {k: np.array(v) for k, v in d.items()}
    B, na, no = d["q"].shape[0], arm.n_arm, cfg.num_objects
    hb = np.asarray(scene.block_half, np.float64)
    arts = [k for k in range(4)
            if scene.has_articulated and fs._real_boxes(scene, k)]
    plan = [("pad_block", o) for o in range(no)]
    plan += [("block_art", k) for k in arts
             if any((h[:2] > hb[:2]).all() for _, _, h in
                    _art_boxes(scene, k, 0.0))]
    plan += [("pad_art", k) for k in arts] + [("pad_world", -1)]
    envs = range(B - CONTACT_ENVS, B)
    ik_envs, ik_targets, block_envs, block_objs = [], [], [], []
    for i, env in enumerate(envs):
        kind, idx = plan[i % len(plan)]
        if kind == "block_art":
            # yaw 0, the block's tilt kept: its footprint inside the box's
            art_q = float(d["art_q"][env, idx])
            boxes = [b for b in _art_boxes(scene, idx, art_q)
                     if (b[2][:2] > hb[:2]).all()]
            c, bq, h = max(boxes, key=lambda b: _top(*b))
            qt = d["obj_quat"][env, 0].astype(np.float64)
            qt[2:] = [0.0, 1.0]
            qt /= np.linalg.norm(qt)
            top = _top(c, bq, h)
            d["obj_quat"][env, 0] = qt
            d["obj_pos"][env, 0] = [c[0], c[1],
                                    top - PEN + (_top(np.zeros(3), qt, hb))]
        elif kind == "pad_block":
            block_envs.append(env)
            block_objs.append(idx)
        else:
            ik_envs.append(env)
            ik_targets.append((kind, idx))
    r0 = float(arm.pad_spheres[0][2])
    if ik_envs:
        aims = np.zeros((len(ik_envs), 3))
        pad0 = np.asarray(_pad0(m, jnp.asarray(d["q"][ik_envs].T))[0]).T
        for j, (env, (kind, idx)) in enumerate(zip(ik_envs, ik_targets)):
            if kind == "pad_art":
                c, bq, h = max(_art_boxes(scene, idx, float(
                    d["art_q"][env, idx])), key=lambda b: _top(*b))
                aims[j] = [c[0], c[1], _top(c, bq, h) + r0 - PEN]
            elif scene.static_pos.shape[0] and cfg.play:
                c = np.asarray(scene.static_pos[0])
                h = np.asarray(scene.static_half[0])
                xy = c[:2] + rs.uniform(-0.5, 0.5, 2) * h[:2]
                aims[j] = [xy[0], xy[1], c[2] + h[2] + r0 - PEN]
            else:
                aims[j] = [pad0[j, 0], pad0[j, 1],
                           float(scene.plane_z) + r0 - PEN]
        q = _pad_ik(m, d["q"][ik_envs].T,
                    jnp.asarray(aims.T.astype(np.float32))).T
        off = d["ctrl_q"][ik_envs] - d["q"][ik_envs, :na]
        d["q"][ik_envs] = q
        d["ctrl_q"][ik_envs] = q[:, :na] + off
    if block_envs:
        # the block comes to pad 0 from below, centred under it: its
        # highest point PEN above the pad's lowest point
        pad0 = np.asarray(_pad0(m, jnp.asarray(d["q"][block_envs].T))[0]).T
        for j, (env, o) in enumerate(zip(block_envs, block_objs)):
            qt = d["obj_quat"][env, o].astype(np.float64)
            p = pad0[j]
            d["obj_pos"][env, o] = [p[0], p[1], p[2] - r0 + PEN
                                    - _top(np.zeros(3), qt, hb)]
    for k in ("q", "ctrl_q", "obj_pos", "obj_quat"):
        d[k] = d[k].astype(np.float32)
    return d


def fidelity_inputs(env_id: str):
    """(the model, FIDELITY_B start states (start_states, the contacts
    placed) with their own servo targets and gripper commands, actions
    (A, B) uniform(-0.3, 0.3) as tests/test_fused.py::
    test_fused_full_step_matches draws them)."""
    m = core.build_model(CATALOG[env_id])
    d = {k: v[:FIDELITY_B] for k, v in start_states(env_id, seed=21).items()}
    d = place_contacts(m, d, seed=22)
    rs = np.random.RandomState(23)
    acts = rs.uniform(-0.3, 0.3, (m.cfg.action_dim, FIDELITY_B)
                      ).astype(np.float32)
    return m, d, acts


def _gap(a, b) -> np.ndarray:
    """[max, mean, p99, p99.9] of |a - b|."""
    x = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return np.array([x.max(), x.mean(), np.quantile(x, 0.99),
                     np.quantile(x, 0.999)])


def oracle_runs(m, d: dict, acts):
    """The vmap oracle on the states d (batch leading): (run_simulation from
    their servo targets and grip, step_physics_only on acts (A, B)), each as
    (packed X (NF, B), servo targets (n_arm, B), grip (B,))."""
    from roboticsplayroompybullet_tpu.envs import physics
    cfg, tree, arm, scene = m.cfg, m.tree, m.arm, m.scene
    st = _state_of(d)
    out = []
    for o in (jax.jit(jax.vmap(lambda s: physics.run_simulation(
                  cfg, tree, arm, scene, s)))(st),
              jax.jit(jax.vmap(lambda s, a: core.step_physics_only(m, s, a)))(
                  st, jnp.asarray(acts.T))):
        out.append((np.asarray(fs.pack_state(cfg, tree, o)),
                    np.asarray(o.ctrl_q).T, np.asarray(o.grip)))
    return out


def _level_fields(cfg, tree, X, ctrl=None, grip=None) -> dict:
    """{field: rows} of packed (NF, ...) rows, plus the step's servo targets
    and grip where given."""
    rows, _ = fs._field_rows(cfg, tree)
    out, i = {}, 0
    for name, r in rows:
        if r:
            out[name] = X[i:i + r]
        i += r
    if ctrl is not None:
        out["targets"], out["grip"] = ctrl, grip[None]
    return out


ULP_DRAWS = 8           # copies of each env's inputs moved by one ulp


def ulp_spread(m, d: dict, acts) -> dict:
    """The oracle's own rounding spread at the inputs: each env run again
    ULP_DRAWS times with every float input (state, servo targets, grip,
    actions) moved one ulp up or down at random, in one batch with the
    unmoved env; per level and field, [max, mean, p99, p99.9] over the
    elements of the largest |moved - unmoved| of each."""
    K = ULP_DRAWS + 1
    rs = np.random.RandomState(24)

    def moved(v):
        v = np.repeat(v, K, 0)
        if v.dtype != np.float32:
            return v
        w = np.nextafter(v, np.where(rs.rand(*v.shape) < 0.5, -np.inf,
                                     np.inf).astype(np.float32))
        w[::K] = v[::K]
        return w

    dk = {k: moved(v) for k, v in d.items()}
    ak = moved(acts.T).T
    out = {}
    for level, (X, c, g) in zip(("sim", "step"), oracle_runs(m, dk, ak)):
        c, g = (c, g) if level == "step" else (None, None)
        for f, v in _level_fields(m.cfg, m.tree, X, c, g).items():
            v = v.reshape(v.shape[0], -1, K)
            out[f"ulp_{level}_{f}"] = _gap(
                np.abs(v - v[..., :1]).max(-1), 0.0)
    return out


def make_fidelity(env_id: str):
    """tools/check_fused.py's sweep on one id, at full fidelity (the
    config's 12 substeps, 8 warm-started iterations) on FIDELITY_B envs:
    the vmap oracle's run_simulation from the states' servo targets and
    grip, and its step_physics_only on the actions (with the servo targets
    and grip it sets), stored whole; JAX's lane twin (make_lane_sim /
    make_lane_control, the body of make_reference_sim / _step, on one row
    of FIDELITY_B lanes) on the same inputs, stored as its gap to the oracle
    per field, [max, mean, p99, p99.9]; the oracle's own spread under a
    one-ulp change of its inputs (ulp_spread) in the same four figures;
    and each contact-row family's rows and active rows at the inputs."""
    t0 = time.time()
    m, d, acts = fidelity_inputs(env_id)
    cfg, tree, arm, scene = m.cfg, m.tree, m.arm, m.scene
    X = np.asarray(fs.pack_state(cfg, tree, _state_of(d)))
    ctrl, grip = d["ctrl_q"].T.copy(), d["grip"].copy()
    cover = contact_rows(m, d)
    print(f"{env_id} inputs {time.time() - t0:.1f} s, contact rows "
          f"(rows, active) {cover}", flush=True)

    t0 = time.time()
    (sim_X, _, _), (step_X, step_ctrl, step_grip) = oracle_runs(m, d, acts)
    print(f"{env_id} oracle {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    spread = ulp_spread(m, d, acts)
    print(f"{env_id} oracle one-ulp spread {time.time() - t0:.1f} s",
          flush=True)

    lane_sim = fs.make_lane_sim(cfg, tree, arm, scene, None, solve_iters=8)
    control = fs.make_lane_control(cfg, tree, arm)

    def sim3(X3, c3, g3):
        lanes = fs._lanes_from_block(cfg, tree, X3)
        return fs._block_from_lanes(cfg, tree, lane_sim(lanes, c3, g3))

    def step3(X3, A3):
        lanes = fs._lanes_from_block(cfg, tree, X3)
        c3, g3 = control(lanes["q"], A3)
        return (fs._block_from_lanes(cfg, tree, lane_sim(lanes, c3, g3)),
                c3, g3)

    t0 = time.time()
    lsim = np.asarray(jax.jit(sim3)(jnp.asarray(X[:, None]),
                                    jnp.asarray(ctrl[:, None]),
                                    jnp.asarray(grip[None])))[:, 0]
    print(f"{env_id} lane sim {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    lstep, lctrl, lgrip = (np.asarray(v)[..., 0, :] for v in jax.jit(step3)(
        jnp.asarray(X[:, None]), jnp.asarray(acts[:, None])))
    print(f"{env_id} lane step {time.time() - t0:.1f} s", flush=True)

    gaps = {}
    for level, got, want in (
            ("sim", _level_fields(cfg, tree, lsim),
             _level_fields(cfg, tree, sim_X)),
            ("step", _level_fields(cfg, tree, lstep, lctrl, lgrip),
             _level_fields(cfg, tree, step_X, step_ctrl, step_grip))):
        for f in got:
            gaps[f"jax_{level}_{f}"] = _gap(got[f], want[f])
    for k, v in dict(gaps, **spread).items():
        print(f"{env_id} {k}: max {v[0]:.3e} mean {v[1]:.3e} p99 "
              f"{v[2]:.3e} p99.9 {v[3]:.3e}", flush=True)
    fams = [f for f in FAMILIES if f in cover]
    _save(f"fidelity_{_key(env_id)}", env_id=np.array(env_id), X=X,
          ctrl=ctrl, grip=grip, actions=acts, sim_X=sim_X, step_X=step_X,
          step_ctrl=step_ctrl, step_grip=step_grip,
          families=np.array(fams),
          rows=np.array([cover[f][0] for f in fams], np.int64),
          active=np.array([cover[f][1] for f in fams], np.int64),
          n_substeps=np.int32(cfg.substeps), solve_iters=np.int32(8),
          **gaps, **spread)


def jobs() -> dict:
    out = {f"reset_{_key(FLAGSHIP)}": flagship_reset,
           "render_camera": make_render_camera,
           "ilqr": lambda: [job() for job in ILQR_JOBS.values()],
           f"step12_{_key(FLAGSHIP)}": make_step12, "rewards": make_rewards,
           "mpc_cost": make_mpc_cost, "mpc_init": make_mpc_init,
           "mpc_sample": make_mpc_sample, "mpc_update": make_mpc_update,
           f"mpc_step_{_key(FLAGSHIP)}": make_mpc_step,
           "mpc_loop_UR5Reach": make_mpc_loop,
           "mpc_plan_loop_UR5Reach": make_mpc_plan_loop,
           "proprio": make_proprio, "eval_data": make_eval_data,
           "eval_pick_acquire": make_eval_pick_acquire,
           f"eval_family_{_key(FLAGSHIP)}": make_eval_family_batch,
           "parallel_fused_UR5Reach": make_parallel_fused,
           "parallel_plan_UR5Reach": make_parallel_plan,
           "launch_ckpt_UR5Reach": make_launch_ckpt}
    out.update(ILQR_JOBS)
    for e in CATALOG:
        out[f"golden_lane_{_key(e)}"] = (lambda e=e: make_golden_lane(e))
    for e in SETTLE_ENVS:
        out[f"settle_{_key(e)}"] = (lambda e=e: make_settle(e))
    for e in CATALOG:
        out[f"fidelity_{_key(e)}"] = (lambda e=e: make_fidelity(e))
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

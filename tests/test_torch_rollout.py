"""PyTorch port: the whole slice — pack, H control steps of the fused
physics, per-step achieved goals, rewards, unpack — through the port's
make_fused_rollout_whole, against the JAX package's
make_fused_rollout_whole(backend="reference") (committed fixtures)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roboticsplayroompybullet_tpu.envs import rewards as jrewards
from roboticsplayroompybullet_tpu.envs.config import CATALOG as JCATALOG

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core, rewards
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs
from roboticsplayroompybullet_torch.parallel import fused as F

import _torch_port as tp

torch.set_num_threads(1)


def _run(env_id):
    z = tp.load(f"rollout_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    st = interop.state_from_numpy(
        {k[3:]: v for k, v in z.items() if k.startswith("in_")})
    roll = F.make_fused_rollout_whole(m, int(z["horizon"]),
                                      n_substeps=int(z["n_substeps"]))
    with torch.no_grad():
        fin, rs, ags = roll(st, torch.tensor(z["actions"]))
    return z, fin, rs, ags


def _check_goals(z, rs, ags):
    d = np.abs(ags.numpy() - z["ags"])
    # IK fixed-point variance (test_fused.py:206-211): bound the tail
    # tightly, allow isolated branch flips at the max
    assert np.quantile(d, 0.99) < 1e-3, np.quantile(d, 0.99)
    assert d.max() < 0.05, d.max()
    assert np.mean(np.abs(rs.numpy() - z["rewards"])) < 0.02


def test_flagship_rollout_matches_jax():
    """UR5 playroom, H=2 at full fidelity (12 substeps, 24 IK iterations,
    8 solve iterations)."""
    z, fin, rs, ags = _run("UR5PlayAbsRPY1Obj-v0")
    assert ags.shape == z["ags"].shape and rs.shape == z["rewards"].shape
    _check_goals(z, rs, ags)
    for f in ("q", "obj_pos", "obj_quat", "art_q"):
        np.testing.assert_allclose(getattr(fin, f).numpy(), z[f"out_{f}"],
                                   rtol=0, atol=5e-4, err_msg=f)
    d = np.abs(fin.qd.numpy() - z["out_qd"])
    assert np.quantile(d, 0.999) < 5e-4, np.quantile(d, 0.999)
    assert d.max() < 5e-3, d.max()
    np.testing.assert_array_equal(fin.t.numpy(), z["out_t"])
    np.testing.assert_array_equal(fin.goal.numpy(), z["out_goal"])


def test_reach_rollout_ag_matches_jax():
    """Reach envs: the achieved goal is the lane-FK ee position."""
    z, fin, rs, ags = _run("UR5Reach-v0")
    assert ags.shape[-1] == 3
    _check_goals(z, rs, ags)


def test_per_step_rollout_equals_whole_horizon():
    """make_fused_rollout (one step per call) and make_fused_batched_step
    give the whole-horizon rollout's results."""
    env_id = "UR5Reach-v0"
    z = tp.load(f"rollout_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    B, H = 16, 2
    st = interop.state_from_numpy(
        {k[3:]: v[:B] for k, v in z.items() if k.startswith("in_")})
    acts = torch.tensor(z["actions"][:B])
    with torch.no_grad():
        f1, r1, a1 = F.make_fused_rollout_whole(m, H, ik_iters=4,
                                                solve_iters=2)(st, acts)
        f2, r2, a2 = F.make_fused_rollout(m, ik_iters=4,
                                          solve_iters=2)(st, acts)
        s1 = F.make_fused_batched_step(m)(st, acts[:, 0])
        f3, _, _ = F.make_fused_rollout_whole(m, 1)(st, acts[:, :1])
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    np.testing.assert_array_equal(f1.q.numpy(), f2.q.numpy())
    np.testing.assert_array_equal(s1.q.numpy(), f3.q.numpy())
    np.testing.assert_array_equal(s1.t.numpy(), f3.t.numpy())
    assert F.supports_fused(m)


def test_batched_step_matches_jax():
    """EnvState-level control step (make_fused_batched_step, the executed
    env step) against the JAX 12-substep step, test_fused.py:114-122."""
    env_id = "UR5PlayAbsRPY1Obj-v0"
    z = tp.load(f"step12_{tp.key(env_id)}")
    d = tp.load(f"reset_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    st = fs.unpack_state(m.cfg, m.tree, torch.tensor(z["X"]),
                         interop.state_from_numpy(d))
    with torch.no_grad():
        out = F.make_fused_batched_step(m)(st, torch.tensor(z["actions"].T))
    X2 = fs.pack_state(m.cfg, m.tree, out).numpy()
    sl = dict(tp.field_slices(m.cfg, m.tree))
    for f in ("q", "obj_pos", "obj_quat"):
        np.testing.assert_allclose(X2[sl[f]], z["X_out"][sl[f]], rtol=0,
                                   atol=5e-4, err_msg=f)
    dqd = np.abs(X2[sl["qd"]] - z["X_out"][sl["qd"]])
    assert np.quantile(dqd, 0.999) < 5e-4 and dqd.max() < 5e-3, dqd.max()
    np.testing.assert_array_equal(out.t.numpy(), d["t"] + 1)
    np.testing.assert_array_equal(out.goal.numpy(), d["goal"])


@pytest.mark.parametrize("env_id", ["UR5PlayAbsRPY1Obj-v0", "pandaPlay-v0",
                                    "pandaPick-v0", "UR5Reach-v0"])
def test_rewards_match_jax(env_id):
    """Play success, sparse and dense rewards on random goals near ags."""
    cfg = CATALOG[env_id]
    rs = np.random.RandomState(4)
    ag = rs.uniform(-0.3, 0.3, (64, 3, cfg.ag_dim)).astype(np.float32)
    g = (ag[:, :1] + rs.uniform(-0.06, 0.06, (64, 1, cfg.ag_dim))
         ).astype(np.float32)
    if not cfg.play:
        g = g[..., :3 * cfg.num_goals]
    ref = np.asarray(jrewards.compute_reward(JCATALOG[env_id],
                                             jnp.asarray(ag), jnp.asarray(g)))
    ours = rewards.compute_reward(cfg, torch.tensor(ag),
                                  torch.tensor(g)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    dense = rewards.dense_reward(torch.tensor(ag), torch.tensor(ag) * 0.5)
    np.testing.assert_allclose(
        dense.numpy(),
        np.asarray(jrewards.dense_reward(jnp.asarray(ag),
                                         jnp.asarray(ag) * 0.5)),
        rtol=1e-6, atol=1e-7)

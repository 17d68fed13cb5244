"""The frozen reference agrees with the port's plain twin at a small size
on the CPU: the same rollout, replan and executed step, bit for bit."""
import numpy as np
import pytest
import torch

from portbench import pools
from portbench.reference import build_model
from portbench.reference.mppi import MPPIConfig, execute, replan
from portbench.reference.plain import Plain


def _inputs(config, env_id, B, H, seed):
    from portbench import harness
    model = build_model(env_id)
    rng = np.random.default_rng(seed)
    conf = harness.load_config(config)
    d = pools.draw(conf, model, rng.integers(0, pools.pool_size(conf, model),
                                             B), rng, qd_noise=0.3)
    X = torch.from_numpy(pools.packed(
        {k: d[k].reshape(B, -1) for k, _ in
         pools.field_rows(model[0], model[1])}, model[0], model[1]))
    acts = torch.from_numpy(rng.uniform(-0.25, 0.25, (H, model[0].action_dim,
                                                      B)).astype(np.float32))
    return model, d, X, acts


@pytest.mark.parametrize("config, env_id", [
    ("ur5-play-absrpy-1obj", "UR5PlayAbsRPY1Obj-v0"),
    ("panda-play-2obj", "pandaPlay-v0"),
])
def test_rollout_is_the_ports_plain_twin(config, env_id):
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs.core import build_model as pm
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    model, _, X, acts = _inputs(config, env_id, 4, 2, 7)
    with torch.no_grad():
        Xr, agr = Plain(model).rollout(X, acts)
        Xp, agp = fs.make_reference_rollout(*pm(CATALOG[env_id]), 2)(X, acts)
    assert torch.equal(Xr, Xp) and torch.equal(agr, agp)


def test_replan_and_step_are_the_ports():
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs.core import build_model as pm
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import fused as F
    from roboticsplayroompybullet_torch.solver import mpc
    env_id = "UR5PlayAbsRPY1Obj-v0"
    model, d, X, _ = _inputs("ur5-play-absrpy-1obj", env_id, 1, 1, 8)
    m = pm(CATALOG[env_id])
    cfg = mpc.MPCConfig(horizon=2, pop=4, iters=2, algorithm="mppi")
    state = interop.state_from_numpy(d, "cpu")
    plan = mpc.PlanState(*(x[0] for x in mpc.init_plan_from_state(
        m, cfg, state)))
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        new, best = mpc.make_fused_planner(m, cfg)(state, plan, gen)
        nxt = F.make_fused_batched_step(m)(state, new.mean[0][None])
        g = torch.Generator().manual_seed(11)
        noises = [torch.randn((1, 4, 2, 7), generator=g) for _ in range(2)]
        rc = MPPIConfig(horizon=2, pop=4, iters=2)
        plain = Plain(model)
        mean, best_r = replan(plain, rc, X, state.goal, plan.mean[None],
                              plan.sigma[None], noises,
                              torch.tensor(model[0].action_high))
        X2, _ = execute(plain, X, mean[:, 0], state.goal)
    assert torch.equal(mean[0], new.mean) and torch.equal(best_r[0], best)
    assert torch.equal(X2, fs.pack_state(m.cfg, m.tree, nxt))

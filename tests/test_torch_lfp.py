"""PyTorch port: the learning-from-play chain (utils/episodelog.py,
utils/checkpoint.py, learn/lfp.py, learn/play_policy.py and the collect /
train / eval tools) against the JAX package on the same inputs.

Tolerances: the window samplers bit for bit (the same numpy code on the
same log and rng); episode logs and checkpoints written by one package
read back equal in the other; the policy's forward within 1e-5 of flax's
output scale (max |Δ| / max |flax|), the MSE loss of the carried
parameters within 1e-6, the
parameters after 1 and 5 Adam steps within 1e-5 of optax.adam's;
quat_from_euler within 1e-6; the play actor's transform on jax.random's
own draws within 1e-6 (actions and state) over 5 steps, its config within
1e-6 (box) and 2e-6 (rest rpy: the port's lane FK against JAX's tree FK,
both float32); the eval's scoring equal to JAX's with JAX's
compute_reward. The JAX calls here are small (no env physics is
compiled).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.learn import lfp, play_policy as pp
from roboticsplayroompybullet_torch.ops import spatial as sp
from roboticsplayroompybullet_torch.utils import checkpoint as ck
from roboticsplayroompybullet_torch.utils import episodelog as elog
from roboticsplayroompybullet_tpu.learn import lfp as jlfp
from roboticsplayroompybullet_tpu.utils import checkpoint as jck
from roboticsplayroompybullet_tpu.utils import episodelog as jelog

import _torch_port as tp
from test_lfp import FIELDS, _make_log

sys.path.insert(0, os.path.join(tp.ROOT, "tools"))

torch.set_num_threads(1)
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"
OBS, GOAL = 12, 5                       # synthetic policy widths
HIGH = (1.5, 1.5, 6.0)


# --------------------------------------------------------------------------
# episode log and window sampling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_episode_logs_interchange(tmp_path, writer):
    """A log either package writes reads back equal in the other."""
    w_mod, r_mod = (jelog, elog) if writer == "jax" else (elog, jelog)
    rng = np.random.default_rng(5)
    fields = {"obs": 5, "act": 3}
    eps = [{k: rng.normal(size=(T, d)).astype(np.float32)
            for k, d in fields.items()} for T in (4, 9, 7)]
    p = str(tmp_path / "x.elog")
    with w_mod.EpisodeWriter(p, fields) as w:
        for ep in eps:
            w.begin_episode()
            w.append_batch(ep)
            w.end_episode()
    with r_mod.EpisodeReader(p, fields=list(fields)) as r:
        assert r.n_episodes == 3 and r.dims == [5, 3]
        for e, ep in enumerate(eps):
            for k in fields:
                np.testing.assert_array_equal(r.read(e, k), ep[k])


def test_window_sampling_matches_jax(tmp_path):
    """relabel_windows, sample_lfp_batch and make_memory_sampler equal
    JAX's bit for bit on tests/test_lfp.py's synthetic log and rng."""
    p = str(tmp_path / "play.elog")
    _make_log(p)
    rs = np.random.default_rng(7)
    obs = rs.normal(size=(3, 5, 4)).astype(np.float32)
    act = rs.normal(size=(3, 5, 2))
    ag = rs.normal(size=(3, 5, 3)).astype(np.float32)
    got, want = lfp.relabel_windows(obs, act, ag), \
        jlfp.relabel_windows(obs, act, ag)
    with elog.EpisodeReader(p, fields=list(FIELDS)) as r, \
            jelog.EpisodeReader(p, fields=list(FIELDS)) as jr:
        b = lfp.sample_lfp_batch(r, np.random.default_rng(1), 8, 6)
        jb = jlfp.sample_lfp_batch(jr, np.random.default_rng(1), 8, 6)
        s = lfp.make_memory_sampler(r, fields=tuple(FIELDS))
        js = jlfp.make_memory_sampler(jr, fields=tuple(FIELDS))
    m, jm = s(np.random.default_rng(2), 16, 6), \
        js(np.random.default_rng(2), 16, 6)
    for a, b_ in ((got, want), (b, jb), (m, jm)):
        assert list(a) == list(b_) == ["obs", "goal", "act"]
        for k in a:
            assert a[k].dtype == b_[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b_[k])


# --------------------------------------------------------------------------
# policy, Adam and checkpoints against flax / optax
# --------------------------------------------------------------------------

def _flax_setup(hidden):
    """flax's policy, numpy parameters drawn at lecun scale in flax's tree
    (its structure from eval_shape: no compile), optax's Adam."""
    policy = jlfp.GoalConditionedPolicy(action_dim=len(HIGH),
                                        action_high=HIGH, hidden=hidden)
    shapes = jax.eval_shape(policy.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, OBS)), jnp.zeros((1, GOAL)))
    rs = np.random.default_rng(len(hidden) + hidden[0])
    params = jax.tree_util.tree_map(
        lambda s: (rs.normal(size=s.shape) / np.sqrt(s.shape[0])
                   ).astype(np.float32) if len(s.shape) == 2 else
        rs.normal(size=s.shape).astype(np.float32) * 0.1, shapes)
    import optax
    return policy, params, optax.adam(3e-4)


def _batches(n, rows=64, seed=3):
    rs = np.random.default_rng(seed)
    return [{"obs": rs.normal(size=(rows, OBS)).astype(np.float32),
             "goal": rs.normal(size=(rows, GOAL)).astype(np.float32),
             "act": rs.uniform(-1, 1, (rows, len(HIGH))).astype(np.float32)}
            for _ in range(n)]


def _port_policy(sd, hidden):
    policy, opt = lfp.init_training(
        torch.Generator().manual_seed(0), OBS, GOAL, len(HIGH), HIGH,
        hidden=hidden, device="cpu")
    policy.load_state_dict(sd)
    return policy, opt


def _assert_params(policy, params, atol, what):
    got = lfp.policy_params_to_jax(policy)
    want = {f"{k}/{n}": v for k, layer in params["params"].items()
            for n, v in layer.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("hidden", [(64, 64), (512, 512)])
def test_policy_and_adam_match_flax(tmp_path, hidden):
    """flax parameters carried by policy_params_from_jax and by a JAX
    save_pytree file give flax's forward, and the first step's loss (on
    those parameters) is optax's; 1 and 5 Adam steps stay with optax's;
    the port's save_pytree loads into JAX's load_pytree."""
    policy_j, params, tx = _flax_setup(hidden)
    batches = _batches(5)
    b0 = batches[0]
    want = np.asarray(jax.jit(policy_j.apply)(params, b0["obs"],
                                              b0["goal"]))

    path = str(tmp_path / "jax.npz")
    jck.save_pytree(path, params)
    sds = {"tree": lfp.policy_params_from_jax(params)}
    with np.load(path) as z:
        sds["np.load"] = lfp.policy_params_from_jax(z)
    policy, opt = _port_policy(sds["tree"], hidden)
    loaded = ck.load_pytree(path, lfp.policy_params_to_jax(policy))
    sds["load_pytree"] = lfp.policy_params_from_jax(loaded)
    pols = {how: _port_policy(sd, hidden)[0] for how, sd in sds.items()}
    with np.load(path) as z:        # the widths from the leaves' shapes
        pols["policy_from_params"] = lfp.policy_from_params(z, HIGH, "cpu")
    assert [x.out_features for x in pols["policy_from_params"].layers] \
        == list(hidden) + [len(HIGH)]
    for how, pol in pols.items():
        with torch.no_grad():
            got = pol(torch.tensor(b0["obs"]), torch.tensor(b0["goal"]))
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (how, err)

    step_j = jax.jit(jlfp.make_train_step(policy_j, tx))
    step = lfp.make_train_step(policy, opt)
    opt_state = tx.init(params)
    for i, b in enumerate(batches):
        params, opt_state, loss_j = step_j(params, opt_state, b)
        loss = step({k: torch.tensor(v) for k, v in b.items()})
        if i == 0:          # the loss of the carried parameters
            assert abs(float(loss) - float(loss_j)) <= 1e-6, (loss, loss_j)
        if i in (0, 4):
            _assert_params(policy, params, 1e-5, f"after {i + 1} steps:")

    # the reverse: the port's file onto flax's template
    out = str(tmp_path / "port.npz")
    ck.save_pytree(out, lfp.policy_params_to_jax(policy))
    back = jck.load_pytree(out, params)
    _assert_params(policy, back, 0, "port file in JAX:")


@pytest.mark.parametrize("goal", ["full_positional_state", "achieved_goal"])
def test_eval_loads_policy_from_its_checkpoint(tmp_path, goal):
    """tools/eval_lfp_torch.py::load_policy takes the widths from the
    file and the fields from the training stats, and refuses a policy
    trained on a goal field it does not score in."""
    from eval_lfp_torch import load_policy
    policy, _ = lfp.init_training(torch.Generator().manual_seed(1), OBS,
                                  GOAL, len(HIGH), HIGH, hidden=(32, 16),
                                  device="cpu")
    path = str(tmp_path / "policy.npz")
    ck.save_pytree(path, lfp.policy_params_to_jax(policy))
    with pytest.raises(SystemExit, match="stats.json"):
        load_policy(path, HIGH, "cpu")
    with open(path + ".stats.json", "w") as f:
        json.dump({"fields": ["obs_quat", "action", goal]}, f)
    if goal != "full_positional_state":
        with pytest.raises(SystemExit, match=goal):
            load_policy(path, HIGH, "cpu")
        return
    got, stats = load_policy(path, HIGH, "cpu")
    assert stats["fields"][2] == goal and not got.training
    b = _batches(1)[0]
    with torch.no_grad():
        want = policy(torch.tensor(b["obs"]), torch.tensor(b["goal"]))
        have = got(torch.tensor(b["obs"]), torch.tensor(b["goal"]))
    assert torch.equal(have, want)


def test_bc_training_loss_decreases(tmp_path):
    """tests/test_lfp.py's case through the port: the windows of a log the
    port wrote, sampled with the one-row shift, are learnable."""
    p = str(tmp_path / "play2.elog")
    rng = np.random.default_rng(2)
    with elog.EpisodeWriter(p, FIELDS) as w:
        for _ in range(6):
            w.begin_episode()
            obs = rng.normal(size=(40, 6)).astype(np.float32)
            ag = np.cumsum(rng.normal(size=(40, 3)) * 0.1,
                           axis=0).astype(np.float32)
            act = np.zeros((40, 2), np.float32)
            act[1:] = obs[:-1, :2] * 0.5 + ag[:-1, :2]
            w.append_batch({"obs_quat": obs, "action": act,
                            "achieved_goal": ag})
            w.end_episode()
    policy, opt = lfp.init_training(
        torch.Generator().manual_seed(0), obs_dim=6, goal_dim=3,
        action_dim=2, action_high=(1.5, 1.5), hidden=(64, 64), device="cpu")
    step = lfp.make_train_step(policy, opt)
    rng = np.random.default_rng(3)
    losses = []
    with elog.EpisodeReader(p, fields=list(FIELDS)) as r:
        for i in range(60):
            batch = lfp.sample_lfp_batch(r, rng, batch=16, window=8)
            losses.append(float(step({k: torch.tensor(v)
                                      for k, v in batch.items()})))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# --------------------------------------------------------------------------
# quat_from_euler and the play actor on JAX's draws
# --------------------------------------------------------------------------

def test_quat_from_euler_matches_jax():
    from roboticsplayroompybullet_tpu.ops import spatial as jsp
    rpy = np.random.default_rng(4).uniform(-3.2, 3.2, (64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(sp.quat_from_euler(torch.tensor(rpy)).numpy(),
                               np.asarray(jsp.quat_from_euler(rpy)),
                               rtol=0, atol=1e-6)


def _jax_draws(key, B, walk, p):
    """The draws JAX's actor step takes from `key`, in its order."""
    kv, kj, kp, kr, kg = jax.random.split(key, 5)
    jump = jax.random.uniform(kj, (B, 1))
    # bernoulli(kj, p) is the same uniform compared with p
    assert bool((jax.random.bernoulli(kj, p, (B, 1)) == (jump < p)).all())
    return pp.ActorDraws(*(torch.tensor(np.asarray(x)) for x in (
        jax.random.normal(kv, (B, walk)), jump,
        jax.random.uniform(kp, (B, 3)), jax.random.normal(kr, (B, 3)),
        jax.random.normal(kg, (B,)))))


@pytest.mark.parametrize("env_id", [FLAGSHIP, "UR5Play1Obj-v0",
                                    "UR5PlayRel1Obj-v0"])
def test_play_actor_matches_jax_on_its_draws(env_id):
    """absolute_rpy, absolute_quat and the raw-box fallback (relative_quat):
    default_actor_config, then 5 steps of _actor_step_from on the draws
    jax.random made for JAX's actor, from JAX's initial state."""
    from roboticsplayroompybullet_tpu.envs import core as jcore
    from roboticsplayroompybullet_tpu.envs.config import CATALOG as JCAT
    from roboticsplayroompybullet_tpu.learn import play_policy as jpp
    m, jm = core.build_model(CATALOG[env_id]), jcore.build_model(JCAT[env_id])
    cfg, jcfg = pp.default_actor_config(m), jpp.default_actor_config(jm)
    np.testing.assert_allclose(cfg.box_lo + cfg.box_hi,
                               jcfg.box_lo + jcfg.box_hi, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cfg.rpy0, jcfg.rpy0, rtol=0, atol=2e-6)
    assert cfg[3:] == jcfg[3:]
    j_init, j_step = jpp.make_play_actor(jm, jcfg)
    j_step = jax.jit(j_step)
    B, walk = 6, 3 if pp._structured(m.cfg) else m.cfg.action_dim
    jst = j_init(jax.random.PRNGKey(11), B)
    st = pp.PlayActorState(*(torch.tensor(np.asarray(x)) for x in jst))
    for t in range(5):
        key = jax.random.PRNGKey(100 + t)
        jst, jacts = j_step(jst, key)
        st, acts = pp._actor_step_from(m.cfg, jcfg, st,
                                       _jax_draws(key, B, walk,
                                                  jcfg.jump_prob))
        assert acts.shape == (B, m.cfg.action_dim)
        np.testing.assert_allclose(acts.numpy(), np.asarray(jacts), rtol=0,
                                   atol=1e-6, err_msg=f"actions, step {t}")
        for name, a, b in zip(st._fields, st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=f"{name}, step {t}")


# --------------------------------------------------------------------------
# the tools: eval scoring, one collection on the CPU
# --------------------------------------------------------------------------

def test_eval_scoring_matches_jax():
    """tools/eval_lfp_torch.py::score against tools/eval_lfp.py's scoring
    (its numpy, JAX's compute_reward) on the same arrays."""
    from roboticsplayroompybullet_tpu.envs.config import CATALOG as JCAT
    from roboticsplayroompybullet_tpu.envs.rewards import compute_reward
    from eval_lfp_torch import score
    cfg, W, N = CATALOG[FLAGSHIP], 5, 48
    rs = np.random.default_rng(9)
    q = rs.normal(size=(N, 2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    goals = np.concatenate([rs.uniform(-0.3, 0.3, (N, 3)), q[:, 0],
                            rs.uniform(0, 1, (N, 1)),
                            rs.uniform(-0.3, 0.3, (N, 3)), q[:, 1],
                            rs.uniform(0, 1, (N, 4))], -1).astype(np.float32)
    scale = rs.choice([0.003, 0.02, 0.2], size=(1, N, 1))
    gs = (goals[None] + rs.normal(size=(W, N, 19)) * scale).astype(np.float32)
    ags = gs[..., 8:]
    got = score(cfg, goals, gs, ags)

    play_ok_fn = jax.jit(jax.vmap(jax.vmap(
        lambda a, g: compute_reward(JCAT[FLAGSHIP], a, g) >= 0.0,
        in_axes=(0, 0)), in_axes=(0, None)))
    d = np.linalg.norm(gs - goals[None], axis=-1)
    ee = np.linalg.norm(gs[..., 0:3] - goals[None, :, 0:3], axis=-1)
    play_ok = np.asarray(play_ok_fn(jnp.asarray(ags),
                                    jnp.asarray(goals[:, 8:])))
    succ = (ee < 0.05) & play_ok
    want = {
        "success_rate_any": float(succ.any(axis=0).mean()),
        "success_rate_final": float(succ[-1].mean()),
        "ee_within_5cm_any": float((ee < 0.05).any(axis=0).mean()),
        "play_ok_final": float(play_ok[-1].mean()),
        "final_dist_mean": float(d[-1].mean()),
        "final_dist_median": float(np.median(d[-1])),
        "best_dist_mean": float(d.min(axis=0).mean()),
        "final_ee_dist_mean_m": float(ee[-1].mean()),
    }
    assert 0 < want["success_rate_any"] < 1 and 0 < want["play_ok_final"] < 1
    assert got == want


def test_collect_play_writes_aligned_log(tmp_path, monkeypatch):
    """tools/collect_play_torch.py on UR5Reach-v0, B=2, T=3, on the CPU:
    the sidecar's order, one episode per env, and row t = (the obs after
    action t, action t) as the step function saw them."""
    import collect_play_torch as C
    from roboticsplayroompybullet_torch.envs.obs import calc_obs
    from roboticsplayroompybullet_torch.parallel import fused
    seen = []
    make = fused.make_fused_batched_step

    def recording(m, **kw):
        step = make(m, **kw)

        def call(states, actions):
            out = step(states, actions)
            seen.append((actions.clone(), calc_obs(*m, out)))
            return out
        return call

    monkeypatch.setattr(fused, "make_fused_batched_step", recording)
    out = str(tmp_path / "p.elog")
    C.main(["--env", "UR5Reach-v0", "--batch", "2", "--steps", "3",
            "--device", "cpu", "--out", out])
    with open(out + ".fields.json") as f:
        names = json.load(f)
    assert names == list(C.PUBLIC) + ["action"]
    with open(out + ".stats.json") as f:
        assert json.load(f)["batch"] == 2
    assert len(seen) == 3
    with elog.EpisodeReader(out, fields=names) as r:
        assert r.n_episodes == 2
        for b in range(2):
            assert r.episode_len(b) == 3
            for t, (acts, obs) in enumerate(seen):
                np.testing.assert_array_equal(r.read(b, "action")[t],
                                              acts[b].numpy())
                for k in C.PUBLIC:
                    np.testing.assert_array_equal(r.read(b, k)[t],
                                                  obs[k][b].numpy())

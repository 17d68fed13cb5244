"""PyTorch port: the full-fidelity sweep (tools/check_fused_torch.py) on the
CPU. The port's plain twin is held to the JAX package's vmap oracle under
the tool's own gates, at the config's 12 substeps and 8 warm-started
iterations, on a slice of the committed fixtures (fidelity_*,
tools/gen_port_fixtures.py; no JAX runs here). The fixtures' schema and
contact coverage are checked for all 19 ids."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs

import _torch_port as tp

sys.path.insert(0, os.path.join(tp.ROOT, "tools"))
import check_fused_torch as cf  # noqa: E402

torch.set_num_threads(1)
# every 4th env: 12 start states and 4 of the 16 placed in contact
SLICE = slice(0, 64, 4)
PER_ENV = ("X", "ctrl", "grip", "actions", "sim_X", "step_X", "step_ctrl",
           "step_grip")
ORACLE_SOURCES = ("roboticsplayroompybullet_tpu/envs/physics.py",
                  "roboticsplayroompybullet_tpu/envs/contact_solver.py",
                  "roboticsplayroompybullet_tpu/ops/contact.py",
                  "roboticsplayroompybullet_tpu/ops/dynamics.py",
                  "roboticsplayroompybullet_tpu/ops/kinematics.py",
                  "roboticsplayroompybullet_tpu/envs/core.py",
                  "roboticsplayroompybullet_tpu/ops/fused_step.py")


@pytest.mark.parametrize("env_id", cf.DEFAULT_ENVS)
def test_plain_twin_holds_to_the_oracle(env_id):
    """The plain twin against the oracle on every 4th env, at the sim and
    step levels, each field under cf.judge_field: JAX's own bounds, widened
    only where JAX's lane twin is past them, and no failure but the
    recorded gaps of the reference (cf.RECORDED). The gate's statistics are
    over the fixture's 64 envs, so the envs off the slice take the oracle's
    own values: no statistic of the 64 is then above its value had those
    envs been run too, and a field that fails here fails the tool's gate.
    The step is make_reference_step's composition, the lane control then
    the lane sim; both levels' sims run as one call (the twin's envs are
    independent columns)."""
    m = core.build_model(CATALOG[env_id])
    cfg, tree = m.cfg, m.tree
    z = cf.load(env_id)
    zs = {k: z[k][..., SLICE] for k in PER_ENV}
    T = torch.tensor
    X = T(zs["X"])
    n = X.shape[1]
    with torch.inference_mode():
        control = fs.make_lane_control(cfg, tree, m.arm)
        ctrl, grip = control(fs._lanes_from_block(cfg, tree, X)["q"],
                             T(zs["actions"]))
        Y = fs.make_reference_sim(*m)(
            torch.cat([X, X], 1), torch.cat([T(zs["ctrl"]), ctrl], 1),
            torch.cat([T(zs["grip"]), grip])).numpy()
    got = {"sim": cf.split(cfg, tree, Y[:, :n]),
           "step": dict(cf.split(cfg, tree, Y[:, n:]),
                        targets=ctrl.numpy(), grip=grip[None].numpy())}
    bad = []
    for level in ("sim", "step"):
        want = cf.oracle(level, m, z)
        assert set(got[level]) == set(want)
        for f, v in got[level].items():
            full = want[f].copy()
            full[..., SLICE] = v
            lane = dict(zip(cf.STATS, z[f"jax_{level}_{f}"]))
            _, _, fails, recorded = cf.judge_field(env_id, level, f, full,
                                                   want[f], lane)
            if fails and not recorded:
                bad.append((level, f, fails))
    assert not bad, bad


def test_recorded_gaps_are_the_references():
    """cf.RECORDED names, for each gap, one env at which the oracle lies
    farther than JAX's bound from the port's plain twin run in float64.
    pandaPlayAbsRPY1Obj holds both kinds (step q at env 36, sim qd at env
    54): the float64 twin runs both envs as one sim call. The other
    entries are these two at other Panda ids."""
    assert {i for i, _, _ in cf.RECORDED} <= set(CATALOG)
    assert {(lv, f, e) for (_, lv, f), e in cf.RECORDED.items()} == {
        ("step", "q", 36), ("sim", "qd", 54)}
    env_id = "pandaPlayAbsRPY1Obj-v0"
    kinds = {(lv, f): e for (i, lv, f), e in cf.RECORDED.items()
             if i == env_id}
    assert kinds == {("step", "q"): 36, ("sim", "qd"): 54}
    m = core.build_model(CATALOG[env_id])
    cfg, tree = m.cfg, m.tree
    z = cf.load(env_id)
    T = lambda k, e: torch.tensor(z[k][..., e:e + 1]).double()  # noqa: E731
    with torch.inference_mode():
        Xs = T("X", 36)
        control = fs.make_lane_control(cfg, tree, m.arm)
        ctrl, grip = control(fs._lanes_from_block(cfg, tree, Xs)["q"],
                             T("actions", 36))
        Y = fs.make_reference_sim(*m)(
            torch.cat([Xs, T("X", 54)], 1),
            torch.cat([ctrl, T("ctrl", 54)], 1),
            torch.cat([grip, T("grip", 54)])).numpy()
    step_q = cf.split(cfg, tree, Y[:, :1])["q"]
    sim_qd = cf.split(cfg, tree, Y[:, 1:])["qd"]
    gap_q = np.abs(step_q - cf.oracle("step", m, z)["q"][:, 36:37]).max()
    gap_qd = np.abs(sim_qd - cf.oracle("sim", m, z)["qd"][:, 54:55]).max()
    assert gap_q > cf.oracle_limits("step", "q")[0][1], gap_q
    assert gap_qd > cf.oracle_limits("sim", "qd")[0][1], gap_qd


@pytest.mark.parametrize("env_id", list(CATALOG))
def test_fidelity_fixture_schema(env_id):
    """Every id's fixture: its inputs and the oracle's outputs at B=64 in
    the packed layout, float32; the source hashes of the oracle's JAX
    files; JAX's lane gap and the oracle's one-ulp spread per field and
    level; and every contact-row
    family of the model (the kernel's row table) with its row count and at
    least one active row."""
    m = core.build_model(CATALOG[env_id])
    cfg, arm = m.cfg, m.arm
    with np.load(os.path.join(tp.FIXTURES,
                              f"fidelity_{tp.key(env_id)}.npz")) as raw:
        assert set(ORACLE_SOURCES) <= set(json.loads(
            str(raw["sources_json"])))
    z = cf.load(env_id)                  # refuses stale source hashes
    assert str(z["env_id"]) == env_id
    _, NF = fs._field_rows(cfg, m.tree)
    B = 64
    shapes = dict(X=(NF, B), sim_X=(NF, B), step_X=(NF, B),
                  ctrl=(arm.n_arm, B), step_ctrl=(arm.n_arm, B),
                  grip=(B,), step_grip=(B,), actions=(cfg.action_dim, B))
    for k, shape in shapes.items():
        assert z[k].shape == shape and z[k].dtype == np.float32, k
        assert np.isfinite(z[k]).all(), k
    assert int(z["n_substeps"]) == cfg.substeps == 12
    assert int(z["solve_iters"]) == 8
    fields = [n for n, r in fs._field_rows(cfg, m.tree)[0] if r]
    for level, extra in (("sim", []), ("step", ["targets", "grip"])):
        for f in fields + extra:
            for g in (z[f"jax_{level}_{f}"], z[f"ulp_{level}_{f}"]):
                assert g.shape == (4,) and (g >= 0).all(), (level, f)
                assert g[2] <= g[3] <= g[0] and g[1] <= g[0], (level, f)
    have, idle, differ = cf.coverage(m, z)
    assert not idle and not differ, (idle, differ)
    assert "pad_world" in have
    assert ("block_world" in have) == (cfg.num_objects > 0)
    assert ("block_block" in have) == (cfg.num_objects == 2)
    assert ("pad_art" in have) == bool(m.scene.has_articulated)


def test_gate_widens_only_where_jax_is_past_it():
    """A bound stays where JAX's lane twin keeps it; past it, it becomes
    the lane twin's figure plus the port's term of the field's kind."""
    keep = dict(zip(cf.STATS, (5e-5, 1e-6, 2e-5, 4e-5)))
    assert cf.gate("sim", "q", keep) == [("max", 1e-4, False, None)]
    assert cf.gate("sim", "qd", keep) == [("max", 1e-4, False, None)]
    past = dict(keep, max=3e-3)
    assert cf.gate("sim", "obj_angvel", past) == [
        ("max", 3e-3 + 1e-3, False, 3e-3)]
    assert cf.gate("sim", "obj_pos", past) == [
        ("max", 3e-3 + 1e-4, False, 3e-3)]
    step = cf.gate("step", "qd", dict(past, **{"p99.9": 6e-4}))
    assert step == [("p99.9", 6e-4 + 1e-3, False, 6e-4),
                    ("max", 5e-3, True, None)]
    assert cf.gate("step", "targets", keep) == [("p99", 1e-3, True, None),
                                                ("max", 0.1, True, None)]


def test_a_recorded_gap_holds_the_other_envs():
    """A field past its bound at the one env cf.RECORDED names for it is a
    recorded failure, and still a failure; past it at another env too, or
    in a field RECORDED does not name, it is not recorded."""
    lane = dict(zip(cf.STATS, (1e-6,) * 4))
    want = np.zeros((9, 64), np.float32)
    got = want.copy()
    got[3, 36] = 5.2e-4
    _, _, fails, rec = cf.judge_field("pandaReach-v0", "step", "q", got,
                                      want, lane)
    assert [e for *_, e in fails] == [[36]] and rec
    _, _, fails, rec = cf.judge_field("UR5Reach-v0", "step", "q", got,
                                      want, lane)
    assert fails and not rec
    got[0, 7] = 5.2e-4
    _, _, fails, rec = cf.judge_field("pandaReach-v0", "step", "q", got,
                                      want, lane)
    assert [e for *_, e in fails] == [[7, 36]] and not rec


def test_twin_check_allows_one_env_outside():
    """Against the plain twin (cf.twin_judge, tests/_torch_port.py::
    judge_step): one env of 64 may leave the one-step bounds; two may not,
    nor a velocity p99 over 1e-3 among the others. The servo targets and
    grip are judged as positions."""
    m = core.build_model(CATALOG["UR5Reach-v0"])
    _, NF = fs._field_rows(m.cfg, m.tree)
    rs = np.random.RandomState(0)
    t = torch.tensor(rs.standard_normal((NF, 64)).astype(np.float32))
    c = torch.tensor(rs.standard_normal((m.arm.n_arm + 1, 64)).astype(
        np.float32))
    q0 = next(sl for f, sl in tp.field_slices(m.cfg, m.tree) if f == "q")
    qd = next(sl for f, sl in tp.field_slices(m.cfg, m.tree) if f == "qd")
    one = t.clone()
    one[q0.start, 5] += 1.0
    _, flips, ok = cf.twin_judge(m, (one, None), (t, None))
    assert (flips, ok) == (1, True)
    two = one.clone()
    two[qd.start, 9] += 1.0
    _, flips, ok = cf.twin_judge(m, (two, None), (t, None))
    assert (flips, ok) == (2, False)
    slow = t.clone()
    slow[qd] += 2e-3
    _, flips, ok = cf.twin_judge(m, (slow, None), (t, None))
    assert (flips, ok) == (0, False)
    aim = c.clone()
    aim[0, 7] += 1e-3
    diffs, flips, ok = cf.twin_judge(m, (one, aim), (t, c))
    assert (flips, ok) == (2, False) and diffs["targets"][0] > 9e-4


def test_tool_runs_the_plain_twin_on_the_cpu(capsys):
    """`check_fused_torch.py UR5Reach-v0 --device cpu` labels the plain twin
    as the first column, leaves the kernel's column empty and exits 0."""
    assert cf.main(["UR5Reach-v0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain twin (no kernel on the CPU)" in out
    assert "### UR5Reach-v0 · sim" in out and "### UR5Reach-v0 · step" in out
    assert "UR5Reach-v0: PASS" in out and "SWEEP PASS over 1 ids" in out
    assert "kernel − plain twin: " not in out

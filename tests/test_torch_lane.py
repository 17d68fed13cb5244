"""PyTorch port: the plain lane twin (ops/fused_step.py) — the plain
version of every fused kernel — against the JAX lane twin's outputs
(committed fixtures), at the tolerances tests/test_fused.py holds the JAX
twins to."""
import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs

import _torch_port as tp

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", [
    "UR5PlayAbsRPY1Obj-v0", "UR5Reach-v0", "pandaPick-v0",
    "pandaPlay-v0"])   # pandaPlay: 2 blocks, block-block rows
def test_sim_matches_jax(env_id):
    """3-substep control interval, every packed field within 1e-4
    (test_fused.py:54)."""
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    sim = fs.make_reference_sim(*m, n_substeps=int(z["n_substeps"]))
    with torch.no_grad():
        X2 = sim(torch.tensor(z["X"]), torch.tensor(z["ctrl"]),
                 torch.tensor(z["grip"])).numpy()
    for name, sl in tp.field_slices(m.cfg, m.tree):
        np.testing.assert_allclose(X2[sl], z["X_out"][sl], rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("env_id", [
    "pandaPlayAbsRPY1Obj-v0",     # absolute_rpy
    "UR5PlayRelRPY1Obj-v0",       # relative_rpy
    "pandaPlay1Obj-v0",           # absolute_quat
    "UR5PlayRel1Obj-v0",          # relative_quat (componentwise quat add)
    "pandaPlayRelJoints1Obj-v0",  # relative_joints
    "UR5PlayAbsJoints1Obj-v0",    # absolute_joints
])
def test_control_matches_jax(env_id):
    """Action decode + DLS IK, all 6 modes (test_fused.py:97-100)."""
    z = tp.load(f"control_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    ctrl = fs.make_lane_control(m.cfg, m.tree, m.arm)
    with torch.no_grad():
        t, g = ctrl(torch.tensor(z["q"]), torch.tensor(z["actions"]))
    d = np.abs(t.numpy() - z["targets"])
    # iterated DLS IK: rounding can land a few solves on marginally
    # different fixed points — quantile bound
    assert np.quantile(d, 0.99) < 1e-3, np.quantile(d, 0.99)
    assert d.max() < 0.1, d.max()
    np.testing.assert_allclose(g.numpy(), z["grip"], rtol=0, atol=1e-6)


def test_full_step_matches_jax():
    """Whole control step (control + 12 substeps, 8 solve iterations) on the
    flagship playroom (test_fused.py:114-122)."""
    env_id = "UR5PlayAbsRPY1Obj-v0"
    z = tp.load(f"step12_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    step = fs.make_reference_step(*m)
    with torch.no_grad():
        X2 = step(torch.tensor(z["X"]), torch.tensor(z["actions"])).numpy()
    sl = dict(tp.field_slices(m.cfg, m.tree))
    for f in ("q", "obj_pos", "obj_quat"):
        np.testing.assert_allclose(X2[sl[f]], z["X_out"][sl[f]], rtol=0,
                                   atol=5e-4, err_msg=f)
    d = np.abs(X2[sl["qd"]] - z["X_out"][sl["qd"]])
    assert np.quantile(d, 0.999) < 5e-4, np.quantile(d, 0.999)
    assert d.max() < 5e-3, d.max()


def test_sphere_box_interior_normal():
    """A sphere center inside a box gets a unit min-axis normal, not a zero
    vector (test_fused.py::test_sphere_box_interior_normal)."""
    c = torch.tensor([0.006, 0.003, -0.003])[:, None]
    half = torch.tensor([0.02, 0.02, 0.005])[:, None]
    _, n, d = fs.lane_sphere_aabox(c, 0.008, torch.zeros(3, 1), half)
    np.testing.assert_allclose(n[:, 0].numpy(), [0.0, 0.0, -1.0], atol=1e-6)
    np.testing.assert_allclose(float(d[0]), 0.008 + 0.002, atol=1e-6)


def test_deepest_takes_the_first_of_equal_depths():
    depth = torch.tensor([[0.1, 0.3], [0.3, 0.3], [0.3, 0.2]])   # (R=3, B=2)
    point = torch.arange(3.0)[None, :, None].expand(3, 3, 2)
    normal = torch.ones(3, 3, 2)
    pt, nm, dp = fs.lane_deepest(point, normal, depth, axis=0)
    np.testing.assert_array_equal(pt[0].numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(dp.numpy(), np.float32([0.3, 0.3]))
    np.testing.assert_array_equal(nm.numpy(), np.ones((3, 2)))

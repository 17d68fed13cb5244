"""PyTorch port: the hand-written CUDA kernel (csrc/fused_step.cu) against
its plain PyTorch version on the same inputs, on the card. These need an
NVIDIA card with nvcc; without one they skip. On the card:

    python -m pytest tests/test_torch_kernel.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs

import _torch_port as tp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("env_id", ["UR5PlayAbsRPY1Obj-v0", "UR5Reach-v0",
                                    "pandaPick-v0", "pandaPlay-v0"])
def test_sim_kernel_matches_plain(cuda, env_id):
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    ns = int(z["n_substeps"])
    args = [torch.tensor(z[k], device=cuda) for k in ("X", "ctrl", "grip")]
    out = fs.make_cuda_sim(*m, n_substeps=ns)(*args)
    ref = fs.make_reference_sim(*m, n_substeps=ns)(*args)
    torch.cuda.synchronize()
    for name, sl in tp.field_slices(m.cfg, m.tree):
        np.testing.assert_allclose(out[sl].cpu().numpy(),
                                   ref[sl].cpu().numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_rollout_kernel_equals_repeated_step_kernel(cuda):
    env_id = "UR5PlayAbsRPY1Obj-v0"
    z = tp.load(f"step12_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    X = torch.tensor(z["X"], device=cuda)
    acts = torch.tensor(np.stack([z["actions"], -z["actions"]]), device=cuda)
    step = fs.make_cuda_step(*m)
    Xs = X
    for h in range(2):
        Xs = step(Xs, acts[h])
    Xr, ags = fs.make_cuda_rollout(*m, horizon=2)(X, acts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(Xr.cpu().numpy(), Xs.cpu().numpy(), rtol=0,
                               atol=1e-5)
    assert ags.shape == (2, fs.ag_layout(m.cfg, m.tree)[1], X.shape[1])


POSITION_FIELDS = ("q", "obj_pos", "obj_quat", "art_q")


def _assert_twin_bounds(m, out, ref):
    """chip_smoke.py's per-field bounds: position-like max ≤ 1e-4,
    velocities p99 ≤ 1e-3 and max ≤ 5e-2."""
    for name, sl in tp.field_slices(m.cfg, m.tree):
        d = (out[sl] - ref[sl]).abs().flatten().cpu().numpy()
        if name in POSITION_FIELDS:
            assert d.max() <= 1e-4, (name, d.max())
        else:
            assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 5e-2, (
                name, np.quantile(d, 0.99), d.max())


def _tiled(z, B, dev):
    reps = -(-B // z["X"].shape[1])
    return [torch.tensor(np.concatenate([z[k]] * reps, axis=-1)[..., :B],
                         device=dev) for k in ("X", "ctrl", "grip")]


@pytest.mark.parametrize("B", [1, 4, 37, 4097])
def test_kernels_match_plain_on_tail_and_multi_wave_batches(cuda, B):
    """B=1 and B=4 are the MPC loops' executed steps (one block, part
    filled); B=37 leaves a part-filled block; B=4097 needs several waves of
    blocks and leaves one env in the last block."""
    env_id = "UR5PlayAbsRPY1Obj-v0"
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    ns = int(z["n_substeps"])
    X, ctrl, grip = _tiled(z, B, cuda)
    rs = np.random.RandomState(B)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (2, m.cfg.action_dim, B)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        _assert_twin_bounds(m, fs.make_cuda_sim(*m, n_substeps=ns)(X, ctrl, grip),
                            fs.make_reference_sim(*m, n_substeps=ns)(X, ctrl, grip))
        kr, kag = fs.make_cuda_rollout(*m, horizon=2, n_substeps=ns)(X, acts)
        pr, pag = fs.make_reference_rollout(*m, horizon=2, n_substeps=ns)(X, acts)
    torch.cuda.synchronize()
    _assert_twin_bounds(m, kr, pr)
    assert float((kag - pag).abs().max()) <= 1e-4


@pytest.mark.parametrize("env_id", ["UR5PlayAbsRPY1Obj-v0", "UR5Reach-v0",
                                    "pandaPick-v0", "pandaPlay-v0"])
def test_step_kernel_matches_plain(cuda, env_id):
    """Control (decode + IK) and 3 substeps for each family of models,
    the 2-object pandaPlay (136 contact rows, every row slot) included."""
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    X = torch.tensor(z["X"], device=cuda)
    rs = np.random.RandomState(0)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (m.cfg.action_dim, X.shape[1])),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        out = fs.make_cuda_step(*m, n_substeps=3)(X, acts)
        ref = fs.make_reference_step(*m, n_substeps=3)(X, acts)
    torch.cuda.synchronize()
    _assert_twin_bounds(m, out, ref)


@pytest.mark.parametrize("env_id", ["UR5PlayAbsRPY1Obj-v0", "pandaPlay-v0"])
def test_step_kernel_hands_back_its_control(cuda, env_id):
    """with_ctrl: the same launch writes the servo targets and gripper
    command it chose (the env step's ctrl_q and grip), at the control
    bounds of the plain control, and the state equals the plain step."""
    z = tp.load(f"sim3_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    X = torch.tensor(z["X"], device=cuda)
    rs = np.random.RandomState(1)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (m.cfg.action_dim, X.shape[1])),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        out, C = fs.make_cuda_step(*m, n_substeps=3, with_ctrl=True)(X, acts)
        ref, Cp = fs.make_reference_step(*m, n_substeps=3, with_ctrl=True)(
            X, acts)
        plain = fs.make_cuda_step(*m, n_substeps=3)(X, acts)
    torch.cuda.synchronize()
    assert C.shape == (m.arm.n_arm + 1, X.shape[1])
    assert torch.equal(out, plain)
    _assert_twin_bounds(m, out, ref)
    d = (C - Cp).abs().flatten().cpu().numpy()
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 0.1, d.max()
    assert torch.equal(C[-1], acts[-1].clamp(-1.0, 1.0))

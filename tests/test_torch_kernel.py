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

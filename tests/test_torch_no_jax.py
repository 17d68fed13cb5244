"""PyTorch port: imports without jax, and its CUDA path never falls back to
the CPU."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import roboticsplayroompybullet_torch as port
from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs
from roboticsplayroompybullet_torch.parallel import fused as F

import _torch_port as tp

torch.set_num_threads(1)
ENV = "UR5Reach-v0"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("ops.fused_step", "ops.grad_step", "solver.mpc",
                 "solver.cost", "solver.eval", "solver.ilqr",
                 "solver.gradient", "envs.obs",
                 "envs.core", "envs.wrapper", "envs.physics", "gym_registry",
                 "parallel.rollout", "parallel.mesh", "parallel.dryrun",
                 "utils.spaces", "utils.render", "utils.profiling",
                 "learn.lfp", "learn.play_policy", "utils.episodelog",
                 "utils.checkpoint", "utils.metrics"):
        assert f"roboticsplayroompybullet_torch.{name}" in mods, name
    tools = sorted(f[:-3] for f in os.listdir(os.path.join(tp.ROOT, "tools"))
                   if f.endswith("_torch.py"))
    assert {"collect_play_torch", "train_lfp_torch", "eval_lfp_torch",
            "launch_distributed_torch", "scaling_torch", "interactive_torch",
            "teleop_bridge_torch", "check_fused_torch"} <= set(tools), tools
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.path.insert(0, 'tools')\n"
        "import importlib\n"
        f"for name in {mods + tools!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.startswith(('jax', 'roboticsplayroompybullet_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tp.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no CUDA card (here), and when run alone, away from the repo."""
    script = os.path.join(tp.ROOT, "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, path in ((tp.ROOT, script), (tmp_path, None)):
        if path is None:
            path = str(tmp_path / "chip_smoke.py")
            with open(script) as src, open(path, "w") as dst:
                dst.write(src.read())
        res = subprocess.run([sys.executable, path], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def _cpu_inputs(B=4):
    m = core.build_model(CATALOG[ENV])
    _, NF = fs._field_rows(m.cfg, m.tree)
    return m, torch.zeros(NF, B), torch.zeros(m.cfg.action_dim, B)


def test_cuda_kernels_raise_on_cpu_tensors():
    m, X, A = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.make_cuda_step(*m)(X, A)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.make_cuda_step(*m, with_ctrl=True)(X, A)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.make_cuda_rollout(*m, horizon=1)(X, A[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.make_cuda_sim(*m)(X, torch.zeros(m.arm.n_arm, 4), torch.zeros(4))
    assert fs.LAUNCHES == {"sim": 0, "step": 0, "rollout": 0}


def test_cuda_kernels_refuse_an_empty_batch():
    """B=0 is refused before anything is launched or counted."""
    m, X, A = _cpu_inputs(B=0)
    with pytest.raises(ValueError, match="empty"):
        fs.make_cuda_step(*m)(X, A)
    with pytest.raises(ValueError, match="empty"):
        fs.make_cuda_rollout(*m, horizon=1)(X, A[None])
    assert fs.LAUNCHES == {"sim": 0, "step": 0, "rollout": 0}


def test_backend_resolution_has_no_fallback():
    m, X, _ = _cpu_inputs()
    assert F._resolve_backend("auto", X) == "reference"
    assert F._resolve_backend("cuda", X) == "cuda"
    with pytest.raises(ValueError):
        F._resolve_backend("pallas", X)
    z = tp.load(f"rollout_{tp.key(ENV)}")
    from roboticsplayroompybullet_torch import interop
    st = interop.state_from_numpy(
        {k[3:]: v[:4] for k, v in z.items() if k.startswith("in_")},
        device="cpu")
    acts = torch.tensor(z["actions"][:4, :1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        F.make_fused_rollout_whole(m, 1, backend="cuda")(st, acts)


def test_state_from_numpy_defaults_to_the_card():
    """States go to the card unless the caller asks for the CPU: here, with
    no CUDA build of torch, the default raises instead of falling back."""
    from roboticsplayroompybullet_torch import interop
    z = tp.load(f"rollout_{tp.key(ENV)}")
    d = {k[3:]: v[:2] for k, v in z.items() if k.startswith("in_")}
    assert interop.state_from_numpy(d, device="cpu").q.device.type == "cpu"
    if torch.cuda.is_available():
        assert interop.state_from_numpy(d).q.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        interop.state_from_numpy(d)

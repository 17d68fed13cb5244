"""roboticsplayroompybullet_torch — the PyTorch/CUDA port of
roboticsplayroompybullet_tpu.

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same path, takes the same inputs in the same layouts and
is tested against it. The port imports torch and numpy, never jax.

Main path (what the JAX bench drives):

    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.parallel import fused
    m = core.build_model(CATALOG["UR5PlayAbsRPY1Obj-v0"])
    roll = fused.make_fused_rollout_whole(m, horizon=40)
    final, rewards, ags = roll(states, actions)   # CUDA tensors → the kernel

On CUDA tensors the fused physics runs in the hand-written kernel
csrc/fused_step.cu; on CPU tensors it runs the plain PyTorch lane twin
(ops/fused_step.py).
"""

__version__ = "0.1.0"

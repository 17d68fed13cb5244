"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch lane twin (twin.py), its model tables (models/), the env presets
(config.py), the rewards, the MPC cost and the MPPI update, and a replay of
the twin from CUDA graphs (graphs.py). Nothing here imports the program or
JAX."""
from __future__ import annotations

from .config import CATALOG
from .models import playroom
from .models.arms import get_arm


def build_model(env_id: str):
    """(cfg, tree, arm, scene) of a catalog env id, as the program's
    envs/core.py::build_model assembles them."""
    cfg = CATALOG[env_id]
    tree, arm = get_arm(cfg.arm)
    kind = cfg.scene_kind
    if kind == "complex":
        scene = playroom.complex_scene(cfg.num_objects)
    elif kind == "push":
        scene = playroom.push_scene(cfg.num_objects)
    else:
        scene = playroom.default_scene(cfg.num_objects)
    return cfg, tree, arm, scene

"""Env core (port of roboticsplayroompybullet_tpu/envs/core.py).

Only the static model bundle is ported so far; control, reset and step
follow the fused lane twin in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

from ..models import playroom
from ..models.arms import get_arm, ArmConfig
from ..models.kinetree import KineTree
from ..models.playroom import Scene
from .config import EnvConfig


class EnvModel(NamedTuple):
    """Static bundle of host numpy constants the physics closes over."""
    cfg: EnvConfig
    tree: KineTree
    arm: ArmConfig
    scene: Scene


def build_model(cfg: EnvConfig) -> EnvModel:
    tree, arm = get_arm(cfg.arm)
    kind = cfg.scene_kind
    if kind == "complex":
        scene = playroom.complex_scene(cfg.num_objects)
    elif kind == "push":
        scene = playroom.push_scene(cfg.num_objects)
    else:
        scene = playroom.default_scene(cfg.num_objects)
    return EnvModel(cfg, tree, arm, scene)

"""Analytic playroom scene model (port of
roboticsplayroompybullet_tpu/models/playroom.py; host numpy only).

The reference builds the world procedurally from Bullet primitives and two
concave trimeshes (scenes.py:46-426). Here every collider is an analytic box
or half-space so the contact kernels stay branch-free and `vmap`-batchable;
the concave door/drawer meshes are replaced by box decompositions derived
from the scaled OBJ bounds (door.obj × 0.0015, drawer2.obj × 1.25 — see
tools/extract_urdf.py provenance notes).

World layout (play / `complex_scene`, scenes.py:46-85):
  plane z = -0.27; tabletop at z = -0.025 top; cabinet around y ≈ 0.45;
  sliding door (prismatic along world x), free drawer caged to slide along y,
  button pad (prismatic z, sprung to 0.03), dial paddle (revolute about y).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# indices of the articulated 1-DoF scene objects in the play state vector
# (order mirrors calc_environment_state: drawer, door, button, dial —
#  environments.py:781-791)
DRAWER, DOOR, BUTTON, DIAL = 0, 1, 2, 3


@dataclass(frozen=True)
class Scene:
    """Static-shaped scene description.

    static_*: fixed world boxes (N_s, ...) — table, cabinet, tray, cage.
    block_*: the movable lego blocks (shared geometry).
    art_*: the four 1-DoF articulated objects [drawer, door, button, dial].
      - anchor: world position of the joint frame at q=0
      - axis: world joint axis (translation dir for prismatic, rotation axis
        for revolute)
      - boxes_pos/half: (4, K, 3) collider boxes attached to each moving
        frame (local coords, at q=0 pose); zero-size boxes are padding.
      - motor_target/force: bullet restoring motors (button: 0.03 @ force 1,
        scenes.py:238); zeros elsewhere.
    """
    static_pos: np.ndarray       # (S,3)
    static_half: np.ndarray      # (S,3)
    static_fric: np.ndarray      # (S,)
    block_half: np.ndarray       # (3,)
    block_mass: np.ndarray       # ()
    block_fric: np.ndarray       # ()
    art_anchor: np.ndarray       # (4,3)
    art_axis: np.ndarray         # (4,3)
    art_boxes_pos: np.ndarray    # (4,K,3) local offsets from anchor
    art_boxes_half: np.ndarray   # (4,K,3)
    art_mass: np.ndarray         # (4,)
    art_lower: np.ndarray        # (4,)
    art_upper: np.ndarray        # (4,)
    art_motor_target: np.ndarray # (4,)
    art_motor_force: np.ndarray  # (4,)
    art_damping: np.ndarray      # (4,)
    plane_z: np.ndarray          # ()
    name: str
    n_blocks: int
    has_articulated: bool
    art_is_revolute: Tuple[bool, ...]


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _pad_boxes(groups, K):
    pos = np.zeros((len(groups), K, 3), dtype=np.float32)
    half = np.zeros((len(groups), K, 3), dtype=np.float32)
    for i, boxes in enumerate(groups):
        for k, (p, h) in enumerate(boxes):
            pos[i, k] = p
            half[i, k] = h
    return pos, half


def default_scene(n_blocks: int = 0) -> Scene:
    """Bare 2x2 m plane at z=-0.07 (scenes.py:8-21)."""
    return _make_scene("default", plane_z=-0.07, statics=[], n_blocks=n_blocks,
                       block_half=[0.025] * 3, block_mass=0.1, block_fric=0.5)


def push_scene(n_blocks: int = 1) -> Scene:
    """Plane + tray walls + one 0.025 block (scenes.py:28-43).

    The pybullet_data traybox is approximated by four low walls around the
    workspace; its floor coincides with the plane for contact purposes.
    """
    w = 0.30
    statics = [
        ([0.0,  w, -0.045], [w, 0.01, 0.03], 0.5),
        ([0.0, -w, -0.045], [w, 0.01, 0.03], 0.5),
        ([ w, 0.0, -0.045], [0.01, w, 0.03], 0.5),
        ([-w, 0.0, -0.045], [0.01, w, 0.03], 0.5),
    ]
    return _make_scene("push", plane_z=-0.07, statics=statics,
                       n_blocks=n_blocks, block_half=[0.025] * 3,
                       block_mass=0.1, block_fric=0.5)


def complex_scene(n_blocks: int = 1) -> Scene:
    """The playroom (scenes.py:46-85): statics + door/drawer/button/dial."""
    statics = [
        # tabletop / cabinet (add_static, scenes.py:103-114). The tabletop
        # is thickened downward (top surface unchanged at z=-0.025) so
        # impacting corners can't cross the slab mid-plane and flip the
        # vertex-contact pushout normal; the extra depth stays clear of the
        # drawer volume (top at z=-0.04 … bottom -0.049 only meets blocks
        # riding impossibly high in the drawer).
        ([0.0, 0.25, -0.037], [0.35, 0.28, 0.012], 1.0),  # tabletop
        ([0.0, 0.52, 0.00], [0.35, 0.01, 0.235], 1.0),    # cabinet back
        ([0.0, 0.45, 0.24], [0.37, 0.065, 0.005], 1.0),   # cabinet top
        ([-0.34, 0.45, 0.0], [0.03, 0.065, 0.235], 1.0),  # cabinet side
        ([0.34, 0.45, 0.0], [0.03, 0.065, 0.235], 1.0),   # cabinet side
        # drawer cage blockers (add_drawer, scenes.py:294-316)
        ([-0.13, 0.25, -0.13], [0.1, 0.28, 0.005], 0.5),  # bottom rail
        ([0.0, 0.25, -0.06], [0.1, 0.05, 0.015], 0.5),    # back stop
        ([-0.25, -0.02, -0.08], [0.03, 0.01, 0.045], 0.5),
        ([0.0, -0.02, -0.08], [0.03, 0.01, 0.045], 0.5),
        # door base block (add_door base collision box, scenes.py:119-120,151)
        ([0.0, 0.4, -0.2], [0.1, 0.1, 0.1], 0.5),
        # button base block (add_button, scenes.py:186-187,214)
        ([0.0, 0.0, -0.7], [0.02, 0.02, 0.005], 0.5),
    ]

    # --- articulated objects -------------------------------------------
    # drawer: free trimesh body caged to slide along y (scenes.py:319-333);
    # abstracted as a prismatic-y tray. Box decomposition of drawer2.obj
    # (×1.25) at default pose [-0.10, 0, -0.04], rot (π/2,0,0):
    # world AABB x[-0.274,0.013] y[-0.231,0.125] z[-0.121,-0.040].
    dx0, dx1 = -0.274, 0.013
    dy0, dy1 = -0.231, 0.125
    dz0, dz1 = -0.121, -0.040
    cx, cy = (dx0 + dx1) / 2, (dy0 + dy1) / 2
    hx, hy = (dx1 - dx0) / 2, (dy1 - dy0) / 2
    wall = 0.008
    drawer_boxes = [
        ([cx, cy, dz0 + wall], [hx, hy, wall]),                    # floor
        ([cx, dy0 + wall, (dz0 + dz1) / 2], [hx, wall, (dz1 - dz0) / 2]),  # front wall (handle side, -y)
        ([cx, dy1 - wall, (dz0 + dz1) / 2], [hx, wall, (dz1 - dz0) / 2]),  # back wall
        ([dx0 + wall, cy, (dz0 + dz1) / 2], [wall, hy, (dz1 - dz0) / 2]),  # left wall
        ([dx1 - wall, cy, (dz0 + dz1) / 2], [wall, hy, (dz1 - dz0) / 2]),  # right wall
        # protruding front lip / handle for grasping
        ([cx, dy0 - 0.012, dz1 - 0.01], [0.04, 0.012, 0.008]),
    ]

    # door: concave trimesh on prismatic link (scenes.py:117-168); base
    # [0,0.4,-0.2], link +[0,0,0.27] rot (0,π/2,0) ⇒ panel slides along
    # world x. door.obj ×0.0015 bounds ⇒ world-frame panel box + handle.
    door_anchor = [0.0, 0.4, 0.07]
    door_boxes = [
        ([0.0, -0.025, 0.072], [0.1495, 0.025, 0.1125]),  # panel
        ([-0.11, -0.068, 0.07], [0.018, 0.018, 0.035]),   # handle bar
    ]

    # button: prismatic-z pad at world [-0.25, 0.45, 0] (scenes.py:184-238)
    button_anchor = [-0.25, 0.45, 0.0]
    button_boxes = [([0.0, 0.0, 0.0], [0.02, 0.02, 0.005])]

    # dial: revolute paddle (scenes.py:345-401); link at [0.2,-0.055,-0.07],
    # rot (π/2,0,0) ⇒ axis [0,0,1]→world (0,-1,0). Paddle half extents in
    # world after the link rotation: [0.03, 0.03, 0.0113]→[0.03,0.0113,0.03].
    dial_anchor = [0.2, -0.055, -0.07]
    dial_boxes = [([0.0, 0.0, 0.0], [0.03, 0.0113, 0.03])]

    boxes_pos, boxes_half = _pad_boxes(
        [drawer_boxes, door_boxes, button_boxes, dial_boxes], K=6)

    return _make_scene(
        "complex", plane_z=-0.27, statics=statics, n_blocks=n_blocks,
        block_half=[0.05, 0.025, 0.025], block_mass=0.3, block_fric=1.5,
        art=dict(
            anchor=[[-0.10, 0.0, -0.04], door_anchor, button_anchor,
                    dial_anchor],
            axis=[[0, 1, 0], [1, 0, 0], [0, 0, 1], [0, -1, 0]],
            boxes_pos=boxes_pos, boxes_half=boxes_half,
            mass=[0.1, 0.1, 0.1, 0.1],
            lower=[-0.22, -0.15, 0.0, -100.0],
            upper=[0.05, 0.15, 0.032, 100.0],
            motor_target=[0.0, 0.0, 0.03, 0.0],
            motor_force=[0.0, 0.0, 1.0, 0.0],
            damping=[2.0, 1.0, 0.2, 0.02],
        ))


def _make_scene(name, plane_z, statics, n_blocks, block_half, block_mass,
                block_fric, art=None) -> Scene:
    if statics:
        spos = np.array([s[0] for s in statics], dtype=np.float32)
        shalf = np.array([s[1] for s in statics], dtype=np.float32)
        sfric = np.array([s[2] for s in statics], dtype=np.float32)
    else:
        spos = np.zeros((0, 3), np.float32)
        shalf = np.zeros((0, 3), np.float32)
        sfric = np.zeros((0,), np.float32)
    if art is None:
        art = dict(anchor=np.zeros((4, 3)), axis=np.tile([0, 0, 1.0], (4, 1)),
                   boxes_pos=np.zeros((4, 1, 3)), boxes_half=np.zeros((4, 1, 3)),
                   mass=np.ones(4) * 0.1, lower=np.zeros(4), upper=np.zeros(4),
                   motor_target=np.zeros(4), motor_force=np.zeros(4),
                   damping=np.ones(4))
        has_art = False
    else:
        has_art = True
    return Scene(
        static_pos=_f32(spos), static_half=_f32(shalf), static_fric=_f32(sfric),
        block_half=_f32(block_half), block_mass=_f32(block_mass),
        block_fric=_f32(block_fric),
        art_anchor=_f32(art["anchor"]), art_axis=_f32(art["axis"]),
        art_boxes_pos=_f32(art["boxes_pos"]), art_boxes_half=_f32(art["boxes_half"]),
        art_mass=_f32(art["mass"]), art_lower=_f32(art["lower"]),
        art_upper=_f32(art["upper"]), art_motor_target=_f32(art["motor_target"]),
        art_motor_force=_f32(art["motor_force"]), art_damping=_f32(art["damping"]),
        plane_z=_f32(plane_z),
        name=name, n_blocks=n_blocks, has_articulated=has_art,
        art_is_revolute=(False, False, False, True),
    )


def dial_to_0_1_range(data):
    """Replicates scenes.py:342-343 *including* its precedence bug:
    `(data % 2*np.pi) / (2.2*np.pi)` parses as `((data % 2)·π)/(2.2·π)`.
    """
    return (data % 2.0) * math.pi / (2.2 * math.pi)

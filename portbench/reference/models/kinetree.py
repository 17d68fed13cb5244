"""Kinematic-tree model: frozen dataclass of host numpy arrays consumed by
FK/IK/dynamics (port of roboticsplayroompybullet_tpu/models/kinetree.py;
the jax pytree registration is dropped — the port never traces it).

Replaces the reference's runtime URDF loading (environments.py:395-416) with an
offline-baked, statically-shaped model. Two views are built:

  * the FULL joint list (all bullet joints incl. fixed) — only used offline to
    derive the reduced tree and named sites; indexing matches PyBullet's joint
    numbering so reference-cited indices (ee=11 panda / 7 ur5, fingers 9/10,
    Robotiq driver 18 etc.) carry over.
  * the REDUCED tree — fixed joints folded into their parent (inertia merged,
    frames composed), leaving only actuated/movable DoFs. This is what the
    kernels (FK/ABA) operate on: small static arrays, one unrolled sweep per
    tree.

Reference parity notes:
  - arm base poses / rest poses / ee indices: environments.py:356-373
  - panda finger gear constraint (joint 10 mirrors 9): environments.py:400-405
  - Robotiq mimic linkage driven open-loop: environments.py:1049-1073
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from . import panda_data, ur5e_data

REVOLUTE, PRISMATIC, FIXED = 0, 1, 2


def _quat_from_euler_np(rpy):
    r, p, y = np.asarray(rpy, dtype=np.float64) * 0.5
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _quat_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_rot_np(q, v):
    qv, qw = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def _compose_np(pa, qa, pb, qb):
    return pa + _quat_rot_np(qa, pb), _quat_mul_np(qa, qb)


def _inertia_mat_np(i6):
    ixx, iyy, izz, ixy, ixz, iyz = i6
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


@dataclass(frozen=True)
class KineTree:
    """Reduced movable-joint tree. All arrays are static-shaped np.float32.

    Frames: reduced link i's frame == the URDF child-link frame of its joint.
    `pre_pos/pre_quat[i]` maps parent reduced link frame -> joint-i frame at
    q_i = 0 (all intervening fixed joints composed in).
    """
    # per movable joint/link  (n_dof rows)
    pre_pos: np.ndarray        # (n, 3)
    pre_quat: np.ndarray       # (n, 4)
    axis: np.ndarray           # (n, 3) joint axis in child link frame
    lower: np.ndarray          # (n,)
    upper: np.ndarray          # (n,)
    effort: np.ndarray         # (n,) max joint force/torque
    max_velocity: np.ndarray   # (n,)
    damping: np.ndarray        # (n,)
    mass: np.ndarray           # (n,) folded (fixed children merged)
    com: np.ndarray            # (n, 3) folded COM in link frame
    inertia: np.ndarray        # (n, 3, 3) folded rotational inertia about COM
    parent_arr: np.ndarray     # (n,) int32 copy of `parent` for vector use
    # named sites: frames rigidly attached to a reduced link
    site_pos: np.ndarray       # (s, 3)
    site_quat: np.ndarray      # (s, 4)
    base_pos: np.ndarray       # (3,) world pose of the tree root
    base_quat: np.ndarray      # (4,)
    # static metadata
    n_dof: int
    parent: Tuple[int, ...]     # python tuple for unrolled sweeps (-1 = base)
    jtype: Tuple[int, ...]      # 0 rev / 1 prism (static per-dof dispatch)
    site_parent: Tuple[int, ...]  # reduced link each site hangs off (-1 = base)
    site_names: Tuple[str, ...]
    name: str

    def site_index(self, name: str) -> int:
        return self.site_names.index(name)


def build_tree(data_mod, base_pos, base_rpy, sites: Dict[str, int],
               name: str, movable_whitelist=None) -> KineTree:
    """Fold fixed joints of a baked URDF table into a reduced KineTree.

    sites: name -> bullet link index; each becomes a rigid frame on the
    reduced tree (q=0 composition of any fixed joints in between).
    movable_whitelist: optional set of bullet joint indices to keep as DoFs
    (others treated as fixed at q=0) — used to drop mimic'd gripper joints.
    """
    joints = data_mod.JOINTS
    n_full = len(joints)

    # full-tree link frames: link i frame reached from parent link via joint i.
    # bullet link index == joint index; parent link index via joint's parent.
    parent_link = [j["parent"] - 1 for j in joints]  # bullet: link -1 is base
    # data tables store parent as link-name index where 0 == root, so shift.

    is_movable = []
    for i, j in enumerate(joints):
        mv = j["type"] != FIXED
        if movable_whitelist is not None and i not in movable_whitelist:
            mv = False
        is_movable.append(mv)

    # reduced index for each full link; fixed links map to nearest movable
    # ancestor (or -1 = base)
    red_of_link = [-1] * n_full
    red_ids = []
    for i in range(n_full):
        if is_movable[i]:
            red_of_link[i] = len(red_ids)
            red_ids.append(i)
        else:
            p = parent_link[i]
            red_of_link[i] = red_of_link[p] if p >= 0 else -1

    n = len(red_ids)

    # accumulated fixed transform from the owning movable link's frame to each
    # full link's frame (at q=0 for folded fixed joints)
    acc_pos = [None] * n_full
    acc_quat = [None] * n_full
    for i in range(n_full):
        j = joints[i]
        jp = np.asarray(j["xyz"], dtype=np.float64)
        jq = _quat_from_euler_np(j["rpy"])
        p = parent_link[i]
        if is_movable[i]:
            # pre-transform: from parent's movable frame, through parent's
            # accumulated fixed chain, to this joint's frame
            if p >= 0:
                pp, pq = acc_pos[p], acc_quat[p]
                pre_p, pre_q = _compose_np(pp, pq, jp, jq)
            else:
                pre_p, pre_q = jp, jq
            acc_pos[i] = np.zeros(3)
            acc_quat[i] = np.array([0.0, 0.0, 0.0, 1.0])
            joints[i]["_pre"] = (pre_p, pre_q)
        else:
            if p >= 0:
                pp, pq = acc_pos[p], acc_quat[p]
                acc_pos[i], acc_quat[i] = _compose_np(pp, pq, jp, jq)
            else:
                acc_pos[i], acc_quat[i] = jp, jq

    # folded inertials: every fixed link contributes to its owning movable link
    fmass = np.zeros(n)
    fmom = np.zeros((n, 3))           # mass * com accumulators
    fI = np.zeros((n, 3, 3))          # inertia about movable-link origin
    contrib = []
    for i in range(n_full):
        r = red_of_link[i]
        if r < 0:
            continue
        j = joints[i]
        m = j["mass"]
        com_l = np.asarray(j["com"], dtype=np.float64)
        cq = _quat_from_euler_np(j["com_rpy"])
        I_c = _inertia_mat_np(j["inertia"])
        # rotate inertia into link axes
        Rl = np.zeros((3, 3))
        for k in range(3):
            e = np.zeros(3); e[k] = 1
            Rl[:, k] = _quat_rot_np(cq, e)
        I_c = Rl @ I_c @ Rl.T
        # transform into owning movable link frame
        op, oq = acc_pos[i], acc_quat[i]
        com_m = op + _quat_rot_np(oq, com_l)
        Rm = np.zeros((3, 3))
        for k in range(3):
            e = np.zeros(3); e[k] = 1
            Rm[:, k] = _quat_rot_np(oq, e)
        I_m = Rm @ I_c @ Rm.T
        # parallel axis to movable link origin
        cx = np.array([[0, -com_m[2], com_m[1]],
                       [com_m[2], 0, -com_m[0]],
                       [-com_m[1], com_m[0], 0]])
        fmass[r] += m
        fmom[r] += m * com_m
        fI[r] += I_m - m * (cx @ cx)

    fcom = fmom / np.maximum(fmass, 1e-9)[:, None]
    # convert origin inertia back to about-COM
    fI_com = np.zeros_like(fI)
    for r in range(n):
        cx = np.array([[0, -fcom[r, 2], fcom[r, 1]],
                       [fcom[r, 2], 0, -fcom[r, 0]],
                       [-fcom[r, 1], fcom[r, 0], 0]])
        fI_com[r] = fI[r] + fmass[r] * (cx @ cx)

    # mass/inertia floors ("armature"): several Robotiq linkage links carry
    # ZERO mass in the reference URDF (ur5e2.urdf); a zero articulated
    # inertia makes ABA's D_i → 0 and the servo/impulse math singular.
    # Bullet papers over this inside its importer; we floor explicitly.
    MASS_FLOOR, INERTIA_FLOOR = 0.05, 2e-5
    fmass = np.maximum(fmass, MASS_FLOOR)
    fI_com = fI_com + np.eye(3) * INERTIA_FLOOR

    pre_pos = np.stack([joints[i]["_pre"][0] for i in red_ids])
    pre_quat = np.stack([joints[i]["_pre"][1] for i in red_ids])
    axis = np.stack([np.asarray(joints[i]["axis"], dtype=np.float64) for i in red_ids])
    nrm = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = axis / np.maximum(nrm, 1e-9)
    jtype = np.array([joints[i]["type"] for i in red_ids], dtype=np.int32)
    lower = np.array([joints[i]["lower"] for i in red_ids])
    upper = np.array([joints[i]["upper"] for i in red_ids])
    effort = np.array([joints[i]["effort"] for i in red_ids])
    max_vel = np.array([joints[i]["velocity"] for i in red_ids])
    damping = np.array([joints[i]["damping"] for i in red_ids])
    rparent = tuple(red_of_link[parent_link[i]] if parent_link[i] >= 0 else -1
                    for i in red_ids)

    sp, sq, spar, snames = [], [], [], []
    for sname, link in sites.items():
        snames.append(sname)
        spar.append(red_of_link[link] if is_movable[link] else red_of_link[link])
        if is_movable[link]:
            sp.append(np.zeros(3)); sq.append(np.array([0., 0., 0., 1.]))
        else:
            sp.append(acc_pos[link]); sq.append(acc_quat[link])

    # host numpy: the port folds these into per-model constants on the host
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return KineTree(
        pre_pos=f32(pre_pos), pre_quat=f32(pre_quat), axis=f32(axis),
        jtype=tuple(int(t) for t in jtype), lower=f32(lower), upper=f32(upper),
        effort=f32(effort), max_velocity=f32(max_vel), damping=f32(damping),
        mass=f32(fmass), com=f32(fcom), inertia=f32(fI_com),
        parent_arr=np.array(rparent, dtype=np.int32),
        site_pos=f32(np.stack(sp) if sp else np.zeros((0, 3))),
        site_quat=f32(np.stack(sq) if sq else np.zeros((0, 4))),
        site_parent=tuple(int(x) for x in spar),
        base_pos=f32(base_pos),
        base_quat=f32(_quat_from_euler_np(base_rpy)),
        n_dof=n, parent=rparent, site_names=tuple(snames), name=name,
    )


# ---------------------------------------------------------------------------
# the two arm models of the playroom (reference environments.py:356-416)
# ---------------------------------------------------------------------------

def panda_tree() -> KineTree:
    """Franka Panda: 7 revolute arm DoFs + 2 prismatic fingers.

    base at [-0.5, 0, -0.05], identity orientation (environments.py:359-363).
    ee = bullet link 11 (grasptarget). Fingers are bullet joints 9/10, geared
    -1 ratio (environments.py:400-405) — both kept as DoFs; the actuation
    layer mirrors them.
    """
    return build_tree(
        panda_data,
        base_pos=[-0.5, 0.0, -0.05], base_rpy=[0.0, 0.0, 0.0],
        sites={"ee": 11, "hand": 8, "finger_left": 9, "finger_right": 10},
        name="panda",
    )


def ur5e_tree() -> KineTree:
    """UR5e + Robotiq 2F-85: 6 revolute arm DoFs + gripper linkage DoFs.

    base at [0.5, -0.1, 0], yaw π/2 (environments.py:367-373). ee = bullet
    link 7 (grasptarget). Gripper DoFs kept: drivers 18/20 (prismatic pads)
    and the revolute linkage joints 10/12/13/15 the reference motors in
    close_gripper (environments.py:1049-1073).
    """
    return build_tree(
        ur5e_data,
        base_pos=[0.5, -0.1, 0.0], base_rpy=[0.0, 0.0, math.pi / 2],
        sites={"ee": 7, "wrist": 6, "pad_left": 19, "pad_right": 21,
               "tool": 9},
        name="ur5e",
    )

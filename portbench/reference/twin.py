"""The plain PyTorch lane twin of the port's fused control step: every
per-env scalar is a (B,) tensor, components ride leading axes, contact
families keep a leading row axis. A frozen copy of the plain half of
roboticsplayroompybullet_torch/ops/fused_step.py (the `make_lane_*` /
`make_reference_*` functions), kept here so that the benchmark's reference
does not move when the program does. It imports nothing of the program.

Layouts are the program's: packed state X (NF, B) float32, actions (A, B)
or (H, A, B), achieved goals (H, ag_dim, B). Control (action decode, DLS
IK) runs in float64, the substeps in float32, as in the kernel.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import lane as ln
from .models.kinetree import KineTree, REVOLUTE
from .models.arms import ArmConfig
from .models.playroom import Scene
from .config import EnvConfig

f32 = np.float32

_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)], dtype=f32)                     # (8,3)


def _np_spatial_inertia(mass, com, inertia_com):
    """Constant 6x6 spatial inertia of a link, folded in float64."""
    c = np.array([[0, -com[2], com[1]],
                  [com[2], 0, -com[0]],
                  [-com[1], com[0], 0]], dtype=np.float64)
    i_o = np.asarray(inertia_com, np.float64) - mass * (c @ c)
    top = np.concatenate([i_o, mass * c], axis=1)
    bot = np.concatenate([mass * c.T, mass * np.eye(3)], axis=1)
    return np.concatenate([top, bot], axis=0).astype(f32)   # (6,6)


def _np_quat_rotate(q, v):
    """numpy constant quat rotate (xyzw), float64."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    u, w = q[:3], q[3]
    return 2 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v \
        + 2 * w * np.cross(u, v)


_CONST_CACHE: dict = {}


def const_on(arr, device) -> torch.Tensor:
    """numpy constant → float32 tensor on `device`, copied there once and
    cached (a copy per call would wait for the card)."""
    a = np.ascontiguousarray(np.asarray(arr, f32))
    key = (a.tobytes(), a.shape, torch.device(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(a, device=device)
        _CONST_CACHE[key] = t
    return t


def _const(arr, like: torch.Tensor) -> torch.Tensor:
    """numpy constant → float32 tensor of shape arr.shape + like.shape
    (an expanded view of the cached constant)."""
    t = const_on(arr, like.device)
    return t.reshape(t.shape + (1,) * like.dim()).expand(t.shape + like.shape)


# ---------------------------------------------------------------------------
# small 6-D helpers on python lists of lane scalars (zero-skipping)
# ---------------------------------------------------------------------------

def _is0(x):
    return isinstance(x, float) and x == 0.0


def _mul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    return a * b


def _acc(a, b):
    if _is0(a):
        return b
    if _is0(b):
        return a
    return a + b


def _neg(x):
    return -x if not _is0(x) else 0.0


def sum6(terms):
    out = 0.0
    for t in terms:
        out = _acc(out, t)
    return out


def m6v(M, v):
    """6x6 (list of lists) @ 6-vec (list)."""
    return [sum6(_mul(M[i][j], v[j]) for j in range(6)) for i in range(6)]


def m6T_v(M, v):
    return [sum6(_mul(M[j][i], v[j]) for j in range(6)) for i in range(6)]


def m6_m6(A, B):
    return [[sum6(_mul(A[i][k], B[k][j]) for k in range(6))
             for j in range(6)] for i in range(6)]


def m6T_m6(A, B):
    return [[sum6(_mul(A[k][i], B[k][j]) for k in range(6))
             for j in range(6)] for i in range(6)]


def m6_add(A, B):
    return [[_acc(A[i][j], B[i][j]) for j in range(6)] for i in range(6)]


def v6_dot(a, b):
    return sum6(_mul(a[i], b[i]) for i in range(6))


def _cross_l(a, b):
    """Cross product on python lists of lane-or-float scalars."""
    return [_acc(_mul(a[1], b[2]), -_mul(a[2], b[1])),
            _acc(_mul(a[2], b[0]), -_mul(a[0], b[2])),
            _acc(_mul(a[0], b[1]), -_mul(a[1], b[0]))]


def _lane_of(x, template):
    """Materialize a possibly-constant scalar as a lane tensor."""
    if isinstance(x, float):
        return torch.full_like(template, x)
    return x + 0.0 * template if x.shape != template.shape else x


# ---------------------------------------------------------------------------
# lane FK (positions + velocities)
# ---------------------------------------------------------------------------

class LaneKin(NamedTuple):
    pos: list       # per link (3, B)
    quat: list      # per link (4, B)
    lv: list        # per link (3, B)
    av: list        # per link (3, B)


def lane_fk_vel(tree: KineTree, q, qd) -> LaneKin:
    """q, qd: (n_dof, B). Mirrors dynamics.fk_vel link-by-link."""
    pos, quat, lv, av = [], [], [], []
    tpl = q[0]
    for i in range(tree.n_dof):
        p = tree.parent[i]
        if p < 0:
            pp = _const(tree.base_pos, tpl)
            pq = _const(tree.base_quat, tpl)
            plv = torch.zeros_like(pp)
            pav = torch.zeros_like(pp)
        else:
            pp, pq, plv, pav = pos[p], quat[p], lv[p], av[p]
        jp = pp + ln.quat_rotate(pq, _const(tree.pre_pos[i], tpl))
        jq = ln.quat_multiply(pq, _const(tree.pre_quat[i], tpl))
        a_const = np.asarray(tree.axis[i], f32)
        if tree.jtype[i] == REVOLUTE:
            dq = ln.quat_from_axis_angle(a_const, q[i])
            jq = ln.quat_normalize(ln.quat_multiply(jq, dq))
        else:
            jp = jp + ln.quat_rotate(jq, _const(a_const, tpl) * q[i][None])
        vlin = plv + ln.cross(pav, jp - pp)
        vang = pav
        a_w = ln.quat_rotate(jq, _const(a_const, tpl))
        if tree.jtype[i] == REVOLUTE:
            vang = vang + a_w * qd[i][None]
        else:
            vlin = vlin + a_w * qd[i][None]
        pos.append(jp)
        quat.append(jq)
        lv.append(vlin)
        av.append(vang)
    return LaneKin(pos, quat, lv, av)


def lane_pad_kinematics(tree: KineTree, arm: ArmConfig, kin: LaneKin):
    """Pad sphere centers/velocities (envs/physics.pad_sphere_kinematics)."""
    centers, vels, radii, dofs = [], [], [], []
    for site, off, r in arm.pad_spheres:
        par = tree.site_parent[site]
        tpl = kin.pos[par][0]
        spos = kin.pos[par] + ln.quat_rotate(
            kin.quat[par], _const(tree.site_pos[site], tpl))
        squat = ln.quat_multiply(kin.quat[par],
                                 _const(tree.site_quat[site], tpl))
        c = spos + ln.quat_rotate(squat, _const(off, tpl))
        v = kin.lv[par] + ln.cross(kin.av[par], c - kin.pos[par])
        centers.append(c)
        vels.append(v)
        radii.append(float(r))
        dofs.append(par)
    return centers, vels, radii, tuple(dofs)


# ---------------------------------------------------------------------------
# lane ABA (6x6 as nested python lists)
# ---------------------------------------------------------------------------

def _joint_transform(tree: KineTree, i: int, qi):
    """Motion transform X_i = [[E, 0], [-E p~, E]] (parent → link i) as a
    6x6 list, and the motion subspace S_i. Revolute: E = R(conj(pre_quat ·
    axis_angle(q_i))), p = pre_pos. Prismatic: E is constant (folded in
    float64) and p = pre_pos + R(pre_quat) axis q_i."""
    a_const = np.asarray(tree.axis[i], f32)
    pre_q = np.asarray(tree.pre_quat[i], f32)
    if tree.jtype[i] == REVOLUTE:
        dq = ln.quat_from_axis_angle(a_const, qi)
        jq = ln.quat_multiply(_const(pre_q, qi), dq)
        Emat = ln.quat_to_mat33(ln.quat_conjugate(jq))       # (3,3,B)
        E = [[Emat[r, c] for c in range(3)] for r in range(3)]
        p_const = np.asarray(tree.pre_pos[i], np.float64)
        px, py, pz = float(p_const[0]), float(p_const[1]), float(p_const[2])
    else:
        x_, y_, z_, w_ = -pre_q[0], -pre_q[1], -pre_q[2], pre_q[3]
        cq = np.array([x_, y_, z_, w_], np.float64)
        E_np = np.array([
            [1 - 2 * (cq[1] ** 2 + cq[2] ** 2),
             2 * (cq[0] * cq[1] - cq[3] * cq[2]),
             2 * (cq[0] * cq[2] + cq[3] * cq[1])],
            [2 * (cq[0] * cq[1] + cq[3] * cq[2]),
             1 - 2 * (cq[0] ** 2 + cq[2] ** 2),
             2 * (cq[1] * cq[2] - cq[3] * cq[0])],
            [2 * (cq[0] * cq[2] - cq[3] * cq[1]),
             2 * (cq[1] * cq[2] + cq[3] * cq[0]),
             1 - 2 * (cq[0] ** 2 + cq[1] ** 2)]])
        E = [[float(E_np[r, c]) for c in range(3)] for r in range(3)]
        Rax = _np_quat_rotate(pre_q, a_const)
        pp_c = np.asarray(tree.pre_pos[i], np.float64)
        px = float(pp_c[0]) + float(Rax[0]) * qi
        py = float(pp_c[1]) + float(Rax[1]) * qi
        pz = float(pp_c[2]) + float(Rax[2]) * qi

    # (E @ skew(p))[r][c] with skew(p) = [[0,-pz,py],[pz,0,-px],[-py,px,0]]
    Sk = [[0.0, _neg(pz), py], [pz, 0.0, _neg(px)], [_neg(py), px, 0.0]]

    def eps(r, c):
        return sum6(_mul(E[r][k], Sk[k][c]) for k in range(3))

    Xi = [[E[0][0], E[0][1], E[0][2], 0.0, 0.0, 0.0],
          [E[1][0], E[1][1], E[1][2], 0.0, 0.0, 0.0],
          [E[2][0], E[2][1], E[2][2], 0.0, 0.0, 0.0],
          [_neg(eps(0, 0)), _neg(eps(0, 1)), _neg(eps(0, 2)),
           E[0][0], E[0][1], E[0][2]],
          [_neg(eps(1, 0)), _neg(eps(1, 1)), _neg(eps(1, 2)),
           E[1][0], E[1][1], E[1][2]],
          [_neg(eps(2, 0)), _neg(eps(2, 1)), _neg(eps(2, 2)),
           E[2][0], E[2][1], E[2][2]]]
    if tree.jtype[i] == REVOLUTE:
        Si = [float(a_const[0]), float(a_const[1]), float(a_const[2]),
              0.0, 0.0, 0.0]
    else:
        Si = [0.0, 0.0, 0.0,
              float(a_const[0]), float(a_const[1]), float(a_const[2])]
    return Xi, Si


def base_gravity_accel(tree: KineTree, gravity: float = -9.8):
    """Fictitious base acceleration (0,0,-g) rotated by conj(base_quat),
    folded in float64 → 6-vector of python floats."""
    bq = np.asarray(tree.base_quat, np.float64)
    gvec = np.array([0.0, 0.0, -float(gravity)])
    x, y, z, w = -bq[0], -bq[1], -bq[2], bq[3]
    uq = np.array([x, y, z])
    g_base = (2 * np.dot(uq, gvec) * uq
              + (w * w - np.dot(uq, uq)) * gvec
              + 2 * w * np.cross(uq, gvec))
    return [0.0, 0.0, 0.0, float(g_base[0]), float(g_base[1]),
            float(g_base[2])]


def lane_aba(tree: KineTree, q, qd, gravity: float = -9.8):
    """Featherstone ABA without external forces (pads-vs-world contact lives
    in the impulse solve). Returns (qdd (n, B), D (n, B))."""
    n = tree.n_dof
    X = [None] * n
    S6 = [None] * n
    v6 = [None] * n
    c6 = [None] * n
    IA = [None] * n
    pA = [None] * n
    for i in range(n):
        Xi, Si = _joint_transform(tree, i, q[i])
        par = tree.parent[i]
        vp = v6[par] if par >= 0 else [0.0] * 6
        vi = m6v(Xi, vp)
        vi = [_acc(vi[j], _mul(Si[j], qd[i])) for j in range(6)]
        # c = v x (S qd)  (motion cross)
        sqd = [_mul(Si[j], qd[i]) for j in range(6)]
        w, u = vi[:3], vi[3:]
        mw, mv = sqd[:3], sqd[3:]
        cx = _cross_l(w, mw)
        cv = [_acc(a, b) for a, b in zip(_cross_l(u, mw), _cross_l(w, mv))]
        ci = cx + cv
        Ii_np = _np_spatial_inertia(float(tree.mass[i]),
                                    np.asarray(tree.com[i], np.float64),
                                    np.asarray(tree.inertia[i], np.float64))
        Ii = [[float(Ii_np[r, c]) for c in range(6)] for r in range(6)]
        Iv = m6v(Ii, vi)
        # p = v x* (I v)
        fw, fv = Iv[:3], Iv[3:]
        pn = [_acc(a, b) for a, b in zip(_cross_l(w, fw), _cross_l(u, fv))]
        pf = _cross_l(w, fv)
        X[i], S6[i], v6[i], c6[i], IA[i], pA[i] = Xi, Si, vi, ci, Ii, pn + pf

    U6 = [None] * n
    D = [None] * n
    u6 = [None] * n
    for i in range(n - 1, -1, -1):
        Ui = m6v(IA[i], S6[i])
        Di = _acc(v6_dot(S6[i], Ui), 1e-9)
        taui = _mul(-float(tree.damping[i]), qd[i])
        ui = _acc(taui, -v6_dot(S6[i], pA[i]))
        U6[i], D[i], u6[i] = Ui, Di, ui
        par = tree.parent[i]
        if par >= 0:
            invD = 1.0 / Di
            Ia = [[_acc(IA[i][r][c], -_mul(_mul(Ui[r], invD), Ui[c]))
                   for c in range(6)] for r in range(6)]
            Iac = m6v(Ia, c6[i])
            uD = _mul(ui, invD)
            pa = [_acc(_acc(pA[i][j], Iac[j]), _mul(Ui[j], uD))
                  for j in range(6)]
            XtIaX = m6T_m6(X[i], m6_m6(Ia, X[i]))
            IA[par] = m6_add(IA[par], XtIaX)
            Xtpa = m6T_v(X[i], pa)
            pA[par] = [_acc(pA[par][j], Xtpa[j]) for j in range(6)]

    a_base = base_gravity_accel(tree, gravity)
    a6 = [None] * n
    qdd = [None] * n
    for i in range(n):
        par = tree.parent[i]
        ap = a6[par] if par >= 0 else a_base
        Xap = m6v(X[i], ap)
        ai = [_acc(Xap[j], c6[i][j]) for j in range(6)]
        num = _acc(u6[i], -v6_dot(U6[i], ai))
        qdd_i = num / D[i]
        a6[i] = [_acc(ai[j], _mul(S6[i][j], qdd_i)) for j in range(6)]
        qdd[i] = qdd_i
    return (torch.stack([_lane_of(qdd[i], q[0]) for i in range(n)]),
            torch.stack([_lane_of(D[i], q[0]) for i in range(n)]))


# ---------------------------------------------------------------------------
# lane contact primitives (component axis FIRST; mirror ops/contact.py)
# ---------------------------------------------------------------------------

def _sgn_nz(x):
    """sign with 0 → +1."""
    s = torch.sign(x)
    return torch.where(s == 0.0, 1.0, s)


def _min_axis_masks(g0, g1, g2):
    a0 = g0 <= torch.minimum(g1, g2)
    a1 = (~a0) & (g1 <= g2)
    a2 = (~a0) & (~a1)
    return a0, a1, a2


def lane_sphere_aabox(c, r, box_pos, box_half):
    """c: (3, ..., B); box_pos/box_half broadcastable (3, ...).
    Returns (point, normal, depth). Mirrors contact.sphere_aabox."""
    d = c - box_pos
    clamped = ln.clip(d, -box_half, box_half)
    out = d - clamped
    dist = torch.sqrt((out * out).sum(0) + 1e-12)
    n_out = out / ln.maximum(dist, 1e-9)[None]
    gap = box_half - torch.abs(d)                    # (3, ...)
    g0, g1, g2 = gap[0], gap[1], gap[2]
    gmin = torch.minimum(g0, torch.minimum(g1, g2))
    a0, a1, a2 = _min_axis_masks(g0, g1, g2)
    n_in = torch.stack([torch.where(a0, torch.sign(d[0]), 0.0),
                        torch.where(a1, torch.sign(d[1]), 0.0),
                        torch.where(a2, torch.sign(d[2]), 0.0)])
    inside = dist < 1e-5   # above the 1e-6 norm floor (contact.sphere_aabox)
    normal = torch.where(inside[None], n_in, n_out)
    depth = torch.where(inside, r + gmin, r - dist)
    point = c - normal * r
    return point, normal, depth


def lane_sphere_obox(c, r, box_pos, box_quat, box_half):
    """Oriented box; box_pos/box_quat are lane tensors."""
    local = ln.quat_rotate_inverse(box_quat, c - box_pos)
    lp, nrm, dep = lane_sphere_aabox(local, r, 0.0, box_half)
    return (box_pos + ln.quat_rotate(box_quat, lp),
            ln.quat_rotate(box_quat, nrm), dep)


def lane_points_aabox(points, box_pos, box_half):
    """Mirror of contact.points_aabox (min-axis pushout at each point)."""
    d = points - box_pos
    gap = box_half - torch.abs(d)
    g0, g1, g2 = gap[0], gap[1], gap[2]
    depth = torch.minimum(g0, torch.minimum(g1, g2))
    a0, a1, a2 = _min_axis_masks(g0, g1, g2)
    normal = torch.stack([torch.where(a0, _sgn_nz(d[0]), 0.0),
                          torch.where(a1, _sgn_nz(d[1]), 0.0),
                          torch.where(a2, _sgn_nz(d[2]), 0.0)])
    return points, normal, depth


def lane_points_aabox_ref(points, ref, box_pos, box_half):
    """Mirror of contact.points_aabox_ref: face chosen from the owning
    body's center; fallback to per-point min-axis when ref is inside."""
    d_ref = ref - box_pos                                   # (3, ..., B)
    ratio = torch.abs(d_ref) / ln.maximum(box_half, 1e-6)
    r0, r1, r2 = ratio[0], ratio[1], ratio[2]
    b0 = r0 >= torch.maximum(r1, r2)
    b1 = (~b0) & (r1 >= r2)
    b2 = (~b0) & (~b1)
    normal = torch.stack([torch.where(b0, _sgn_nz(d_ref[0]), 0.0),
                          torch.where(b1, _sgn_nz(d_ref[1]), 0.0),
                          torch.where(b2, _sgn_nz(d_ref[2]), 0.0)])
    dp = points - box_pos
    abs_n = torch.abs(normal)
    depth_face = (box_half * abs_n).sum(0) - (dp * normal).sum(0)
    inside_other = (torch.abs(dp) * (1.0 - abs_n)
                    <= box_half * (1.0 - abs_n) + 1e-6).all(0)
    ref_inside = (r0 < 1.0) & (r1 < 1.0) & (r2 < 1.0)
    _, fb_n, fb_d = lane_points_aabox(points, box_pos, box_half)
    depth = torch.where(inside_other, depth_face, -1.0)
    depth = torch.where(ref_inside, fb_d, depth)
    normal = torch.where(ref_inside[None], fb_n, normal)
    return points, normal, depth


def lane_points_obox_ref(points, ref, box_pos, box_quat, box_half):
    local_p = ln.quat_rotate_inverse(box_quat, points - box_pos)
    local_r = ln.quat_rotate_inverse(box_quat, ref - box_pos)
    lp, nrm, dep = lane_points_aabox_ref(local_p, local_r, 0.0, box_half)
    return (box_pos + ln.quat_rotate(box_quat, lp),
            ln.quat_rotate(box_quat, nrm), dep)


def lane_deepest(point, normal, depth, axis):
    """First-max manifold reduction along a family axis: of equal depths
    the lowest index wins."""
    dmax = depth.amax(dim=axis, keepdim=True)
    m = depth == dmax
    first = m & (torch.cumsum(m.to(torch.int32), dim=axis) == 1)
    w = first.to(depth.dtype)
    pt = (point * w[None]).sum(axis + 1)
    nm = (normal * w[None]).sum(axis + 1)
    dp = (depth * w).sum(axis)
    return pt, nm, dp


# ---------------------------------------------------------------------------
# contact bundles
# ---------------------------------------------------------------------------

class Bundle(NamedTuple):
    """One contact family: R rows sharing static body assignment.
    point/normal: (3, R, B); depth: (R, B); vkin: (3, R|1, B) or None;
    mu: float; a/b/k/g: static indices (−1 absent)."""
    point: torch.Tensor
    normal: torch.Tensor
    depth: torch.Tensor
    vkin: Optional[torch.Tensor]
    mu: float
    a: int = -1
    b: int = -1
    k: int = -1
    g: int = -1
    pj: int = -1   # pad index: ARM-COUPLED pad-vs-world row


def _real_boxes(scene: Scene, k: int):
    nK = scene.art_boxes_pos.shape[1]
    return [b for b in range(nK)
            if float(np.sum(scene.art_boxes_half[k, b])) > 0.0]


def _lane_art_pose(scene: Scene, k: int, art_q):
    """(pos v3, quat) of articulated frame k (physics.art_box_pose)."""
    tpl = art_q[k]
    anchor = _const(scene.art_anchor[k], tpl)
    axis = np.asarray(scene.art_axis[k], f32)
    if scene.art_is_revolute[k]:
        quat = ln.quat_from_axis_angle(axis, art_q[k])
        pos = anchor + 0.0 * art_q[k][None]
        return pos, quat
    pos = anchor + _const(axis, tpl) * art_q[k][None]
    quat = _const(np.array([0, 0, 0, 1], f32), tpl)
    return pos, quat


def gather_bundles(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                   scene: Scene, st: dict, kin2: LaneKin, qd_arm,
                   pads_c, pads_v, pads_r, pad_dofs) -> Tuple[list, dict]:
    """Reduced-manifold contact bundles (envs/physics.gather_contacts,
    post-reduction). Returns (bundles, aux) with aux carrying gripper data."""
    n_obj = cfg.num_objects
    n_pads = len(pads_c)
    grip_dofs = tuple(dict.fromkeys(pad_dofs))
    grip_slots = tuple(grip_dofs.index(d) for d in pad_dofs)
    u_g = [ln.quat_rotate(kin2.quat[d], _const(tree.axis[d], kin2.pos[d][0]))
           for d in grip_dofs]
    pads_v_nog = [pads_v[p] - u_g[grip_slots[p]] * qd_arm[pad_dofs[p]][None]
                  for p in range(n_pads)]

    mu_world = float(scene.block_fric) * 0.5
    mu_pad = float(scene.block_fric)
    tpl = st["art_q"][0]                                # (B,) template
    up = _const(np.array([0, 0, 1], f32), tpl)
    bundles: List[Bundle] = []

    corners_of = {}
    for o in range(n_obj):
        op = st["obj_pos"][o][:, None]                  # (3,1,B)
        oq = st["obj_quat"][o][:, None]                 # (4,1,B)
        local = _const((_CORNER_SIGNS
                        * np.asarray(scene.block_half, f32)[None]).T, tpl)
        corners = op + ln.quat_rotate(oq, local)        # (3,8,B)
        corners_of[o] = corners

        # floor: depth = plane_z - z, normal +z (points_halfspace)
        nrm = up[:, None].expand(corners.shape)
        dep = float(scene.plane_z) - corners[2]
        bundles.append(Bundle(corners, nrm, dep, None, mu_world, a=o))

        # statics: deepest per corner over the static-box family
        if scene.static_pos.shape[0] > 0:
            pts = corners[:, :, None]                   # (3,8,1,B)
            ref = st["obj_pos"][o][:, None, None]
            bp = _const(scene.static_pos.T, tpl)[:, None]   # (3,1,Sn,B)
            bh = _const(scene.static_half.T, tpl)[:, None]
            p_, n_, d_ = lane_points_aabox_ref(pts, ref, bp, bh)
            p_, n_, d_ = lane_deepest(p_, n_, d_, axis=1)
            bundles.append(Bundle(p_, n_, d_, None, mu_world, a=o))

        # articulated boxes: deepest real box per corner, per element k
        if scene.has_articulated:
            for k in range(4):
                bs = _real_boxes(scene, k)
                if not bs:
                    continue
                bpos, bquat = _lane_art_pose(scene, k, st["art_q"])
                ps, ns, ds = [], [], []
                for b in bs:
                    center = bpos + ln.quat_rotate(
                        bquat, _const(scene.art_boxes_pos[k, b], tpl))
                    bh = _const(scene.art_boxes_half[k, b], tpl)
                    p_, n_, d_ = lane_points_obox_ref(
                        corners, st["obj_pos"][o][:, None],
                        center[:, None], bquat[:, None], bh[:, None])
                    ps.append(p_)
                    ns.append(n_)
                    ds.append(d_)
                p_ = torch.stack(ps, 2)                 # (3,8,nb,B)
                n_ = torch.stack(ns, 2)
                d_ = torch.stack(ds, 1)                 # (8,nb,B)
                p_, n_, d_ = lane_deepest(p_, n_, d_, axis=1)
                bundles.append(Bundle(p_, n_, d_, None,
                                      0.5 * float(scene.block_fric),
                                      a=o, k=k))

        # pads vs this block (normal flipped INTO the block)
        for p in range(n_pads):
            pt, nm, dp = lane_sphere_obox(pads_c[p], pads_r[p],
                                          st["obj_pos"][o],
                                          st["obj_quat"][o],
                                          _const(scene.block_half, tpl))
            bundles.append(Bundle(pt[:, None], -nm[:, None], dp[None],
                                  pads_v_nog[p][:, None], mu_pad,
                                  a=o, g=grip_slots[p]))

    if n_obj == 2:
        p_, n_, d_ = lane_points_obox_ref(
            corners_of[0], st["obj_pos"][0][:, None],
            st["obj_pos"][1][:, None], st["obj_quat"][1][:, None],
            _const(scene.block_half, tpl)[:, None])
        bundles.append(Bundle(p_, n_, d_, None, float(scene.block_fric),
                              a=0, b=1))

    # pads vs articulated: deepest real box per pad per element
    if scene.has_articulated:
        for k in range(4):
            bs = _real_boxes(scene, k)
            if not bs:
                continue
            bpos, bquat = _lane_art_pose(scene, k, st["art_q"])
            for p in range(n_pads):
                ps, ns, ds = [], [], []
                for b in bs:
                    center = bpos + ln.quat_rotate(
                        bquat, _const(scene.art_boxes_pos[k, b], tpl))
                    pt, nm, dp = lane_sphere_obox(
                        pads_c[p], pads_r[p], center, bquat,
                        _const(scene.art_boxes_half[k, b], tpl))
                    ps.append(pt)
                    ns.append(-nm)
                    ds.append(dp)
                p_ = torch.stack(ps, 1)                 # (3,nb,B)
                n_ = torch.stack(ns, 1)
                d_ = torch.stack(ds, 0)                 # (nb,B)
                pt, nm, dp = lane_deepest(p_, n_, d_, axis=0)
                # pj: arm-coupled (finger on a limit-blocked element is
                # resisted through the arm chain — see contact_solver)
                bundles.append(Bundle(pt[:, None], nm[:, None], dp[None],
                                      pads_v_nog[p][:, None], 0.6,
                                      k=k, g=grip_slots[p], pj=p))

    # pads vs WORLD (floor + deepest static), ARM-COUPLED
    for p in range(n_pads):
        dep = float(pads_r[p]) - (pads_c[p][2] - float(scene.plane_z))
        pt = pads_c[p] - up * float(pads_r[p])
        bundles.append(Bundle(pt[:, None], -up[:, None], dep[None],
                              pads_v_nog[p][:, None], 0.6,
                              g=grip_slots[p], pj=p))
        if scene.static_pos.shape[0] > 0:
            bp = _const(scene.static_pos.T, tpl)        # (3,Sn,B)
            bh = _const(scene.static_half.T, tpl)
            p_, n_, d_ = lane_sphere_aabox(pads_c[p][:, None],
                                           pads_r[p], bp, bh)
            pt, nm, dp = lane_deepest(p_, -n_, d_, axis=0)
            bundles.append(Bundle(pt[:, None], nm[:, None], dp[None],
                                  pads_v_nog[p][:, None], 0.6,
                                  g=grip_slots[p], pj=p))

    # pad point Jacobians over the ARM joints (physics.pad_point_jacobians)
    pad_J = []
    for p, (site, _, _) in enumerate(arm.pad_spheres):
        anc = _ancestors(tree, tree.site_parent[site])
        cols = []
        for j in range(arm.n_arm):
            if j not in anc:
                cols.append(None)
                continue
            a_w = ln.quat_rotate(kin2.quat[j], _const(tree.axis[j], tpl))
            if tree.jtype[j] == REVOLUTE:
                cols.append(ln.cross(a_w, pads_c[p] - kin2.pos[j]))
            else:
                cols.append(a_w)
        pad_J.append(cols)                # list P of list n_arm of (3,B)

    aux = dict(grip_dofs=grip_dofs, grip_slots=grip_slots, u_g=u_g,
               pad_J=pad_J)
    return bundles, aux


def _ancestors(tree: KineTree, link: int) -> set:
    anc = set()
    while link >= 0:
        anc.add(link)
        link = tree.parent[link]
    return anc


# ---------------------------------------------------------------------------
# lane Jacobi impulse solve — mirrors envs/contact_solver.solve on bundles
# ---------------------------------------------------------------------------

def lane_solve(cfg: EnvConfig, scene: Scene, bundles: List[Bundle],
               st: dict, inv_I_world, inv_m_blk,
               u_g, inv_m_grip, grip_qd0, art_qd0, dt: float,
               pad_J, inv_D_arm, lam0=None,
               iters: int = 8, relax: float = 1.0, beta: float = 0.2,
               slop: float = 5e-4, v_push_max: float = 0.05):
    """Warm-started Jacobi impulse solve. lam0=None means a zero warm start
    (the first substep of a control interval): the re-mask/re-cap and the
    gear projection of the warm start still run, as in the JAX twin, whose
    make_lane_sim always passes a (zero) λ."""
    n_obj = cfg.num_objects
    G = len(u_g)
    tpl = st["art_q"][0]
    n_arm = len(inv_D_arm)
    eps_lim = 1e-4
    at_low = [(st["art_q"][k] <= float(scene.art_lower[k]) + eps_lim)
              for k in range(4)]
    at_high = [(st["art_q"][k] >= float(scene.art_upper[k]) - eps_lim)
               for k in range(4)]

    def art_mobile(k, j_dir):
        blocked = (at_low[k] & (j_dir < 0.0)) | (at_high[k] & (j_dir > 0.0))
        return torch.where(blocked, 0.0, 1.0)

    # per-bundle precomputation (positions fixed during the velocity solve)
    pre = []
    for bd in bundles:
        active = bd.depth > 0.0
        af = active.to(torch.float32)
        v_target = ln.minimum(
            beta * ln.maximum(bd.depth - slop, 0.0) / dt, v_push_max)
        r_a = bd.point - st["obj_pos"][bd.a][:, None] if bd.a >= 0 else None
        r_b = bd.point - st["obj_pos"][bd.b][:, None] if bd.b >= 0 else None
        if bd.k >= 0:
            rtpl = bd.depth[0]
            axis_c = _const(scene.art_axis[bd.k], rtpl)[:, None]
            if scene.art_is_revolute[bd.k]:
                anchor_c = _const(scene.art_anchor[bd.k], rtpl)[:, None]
                u_art = ln.cross(axis_c.expand(bd.point.shape),
                                 bd.point - anchor_c)
            else:
                u_art = axis_c.expand(bd.point.shape)
        else:
            u_art = None
        # tangent basis (contact_solver._tangent_basis)
        nz = torch.abs(bd.normal[2]) < 0.9
        ax = torch.stack([torch.where(nz, 0.0, 1.0),
                          torch.zeros_like(bd.normal[0]),
                          torch.where(nz, 1.0, 0.0)])
        t1 = ln.cross(bd.normal, ax)
        t1 = t1 / torch.sqrt((t1 * t1).sum(0) + 1e-12)[None]
        t2 = ln.cross(bd.normal, t1)
        pre.append(dict(af=af, v_target=v_target, r_a=r_a,
                        r_b=r_b, u_art=u_art, t1=t1, t2=t2))

    # mass-splitting counts per body (contact_solver.solve:120-133)
    zeros = torch.zeros_like(tpl)
    cnt_blk = [zeros for _ in range(max(n_obj, 1))]
    cnt_art = [zeros for _ in range(4)]
    cnt_grip = [zeros for _ in range(max(G, 1))]
    cnt_arm = zeros
    for bd, pr in zip(bundles, pre):
        s = pr["af"].sum(0)
        if bd.a >= 0:
            cnt_blk[bd.a] = cnt_blk[bd.a] + s
        if bd.b >= 0:
            cnt_blk[bd.b] = cnt_blk[bd.b] + s
        if bd.k >= 0:
            cnt_art[bd.k] = cnt_art[bd.k] + s
        if bd.g >= 0:
            cnt_grip[bd.g] = cnt_grip[bd.g] + s
        if bd.pj >= 0:
            cnt_arm = cnt_arm + s

    inv_m_art = [1.0 / float(scene.art_mass[k]) for k in range(4)]

    def k_dir(bd, pr, d):
        k = 0.0
        if bd.a >= 0:
            ua = ln.cross(pr["r_a"], d)
            term = inv_m_blk + ln.dot(ua, ln.mat33_vec(
                inv_I_world[bd.a][:, :, None], ua))
            k = _acc(k, term * ln.maximum(cnt_blk[bd.a], 1.0)[None])
        if bd.b >= 0:
            ub = ln.cross(pr["r_b"], d)
            term = inv_m_blk + ln.dot(ub, ln.mat33_vec(
                inv_I_world[bd.b][:, :, None], ub))
            k = _acc(k, term * ln.maximum(cnt_blk[bd.b], 1.0)[None])
        if bd.k >= 0:
            ja = ln.dot(pr["u_art"], d)
            sign = -1.0 if bd.a >= 0 else 1.0
            mob = art_mobile(bd.k, ja * sign)
            k = _acc(k, ja * ja * inv_m_art[bd.k] * mob
                     * ln.maximum(cnt_art[bd.k], 1.0)[None])
        if bd.g >= 0:
            jg = ln.dot(u_g[bd.g][:, None], d)
            k = _acc(k, jg * jg * inv_m_grip[bd.g][None]
                     * ln.maximum(cnt_grip[bd.g], 1.0)[None])
        if bd.pj >= 0:
            split = ln.maximum(cnt_arm, 1.0)[None]
            for j in range(n_arm):
                col = pad_J[bd.pj][j]
                if col is None:
                    continue
                jd = ln.dot(col[:, None], d)
                k = _acc(k, jd * jd * inv_D_arm[j][None] * split)
        return ln.maximum(k, 1e-8)

    for bd, pr in zip(bundles, pre):
        pr["k_n"] = k_dir(bd, pr, bd.normal)
        pr["k_t1"] = k_dir(bd, pr, pr["t1"])
        pr["k_t2"] = k_dir(bd, pr, pr["t2"])

    def rel_vel(bd, pr, ov, ow, aqd, gqd, adqd):
        v_a = (ov[bd.a][:, None] + ln.cross(ow[bd.a][:, None], pr["r_a"])
               ) if bd.a >= 0 else None
        v_b = (ov[bd.b][:, None] + ln.cross(ow[bd.b][:, None], pr["r_b"])
               ) if bd.b >= 0 else None
        v_art = pr["u_art"] * aqd[bd.k][None] if bd.k >= 0 else None
        v_grip = u_g[bd.g][:, None] * gqd[bd.g][None] if bd.g >= 0 else None
        vB = 0.0
        if v_b is not None:
            vB = _acc(vB, v_b)
        if v_art is not None and bd.a >= 0:
            vB = _acc(vB, v_art)
        if v_grip is not None:
            vB = _acc(vB, v_grip)
        if bd.pj >= 0:
            # dynamic arm correction on the pad side (baseline in vkin)
            for j in range(n_arm):
                col = pad_J[bd.pj][j]
                if col is not None:
                    vB = _acc(vB, col[:, None] * adqd[j][None])
        if bd.vkin is not None:
            vB = _acc(vB, bd.vkin)
        if bd.a >= 0:
            vA = v_a
        elif bd.k >= 0:
            vA = v_art
        else:
            vA = 0.0
        if _is0(vB):
            return vA
        if _is0(vA):
            return -vB
        return vA - vB

    def apply_all(ov, ow, aqd, gqd, adqd, imps):
        """Apply per-bundle world impulses (side A; −imp on side B) to all
        solver participants, then the gear projection (contact_solver.
        apply_impulses/gear_project)."""
        d_ov = [torch.zeros_like(v) for v in ov]
        d_ow = [torch.zeros_like(v) for v in ow]
        d_aqd = [torch.zeros_like(tpl) for _ in range(4)]
        d_gqd = [torch.zeros_like(g) for g in gqd]
        d_arm = [torch.zeros_like(tpl) for _ in range(n_arm)]
        for (bd, pr), imp in zip(zip(bundles, pre), imps):
            if bd.a >= 0:
                d_ov[bd.a] = d_ov[bd.a] + imp.sum(1) * inv_m_blk
                torq = ln.cross(pr["r_a"], imp).sum(1)
                d_ow[bd.a] = d_ow[bd.a] + ln.mat33_vec(inv_I_world[bd.a],
                                                       torq)
            if bd.b >= 0:
                d_ov[bd.b] = d_ov[bd.b] - imp.sum(1) * inv_m_blk
                torq = ln.cross(pr["r_b"], -imp).sum(1)
                d_ow[bd.b] = d_ow[bd.b] + ln.mat33_vec(inv_I_world[bd.b],
                                                       torq)
            if bd.k >= 0:
                sign = -1.0 if bd.a >= 0 else 1.0
                jrow = ln.dot(pr["u_art"], imp) * sign          # (R,B)
                jrow = jrow * art_mobile(bd.k, jrow)
                d_aqd[bd.k] = d_aqd[bd.k] + jrow.sum(0) * inv_m_art[bd.k]
            if bd.g >= 0:
                jg = -ln.dot(u_g[bd.g][:, None], imp).sum(0)
                d_gqd[bd.g] = d_gqd[bd.g] + jg * inv_m_grip[bd.g]
            if bd.pj >= 0:
                # arm chain (side B): Δqd_j += −(J_j · imp) · D_j⁻¹
                for j in range(n_arm):
                    col = pad_J[bd.pj][j]
                    if col is None:
                        continue
                    jj = -ln.dot(col[:, None], imp).sum(0)
                    d_arm[j] = d_arm[j] + jj * inv_D_arm[j]
        ov = [v + d for v, d in zip(ov, d_ov)]
        ow = [v + d for v, d in zip(ow, d_ow)]
        aqd = aqd + torch.stack(d_aqd)
        gqd = [g + d for g, d in zip(gqd, d_gqd)]
        adqd = [a + d for a, d in zip(adqd, d_arm)]
        # gear projection (contact_solver.gear_project)
        if G == 2:
            w0, w1 = inv_m_grip[0], inv_m_grip[1]
            err = gqd[0] - gqd[1]
            p = err / (w0 + w1)
            gqd = [gqd[0] - p * w0, gqd[1] + p * w1]
        return ov, ow, aqd, gqd, adqd

    def body(ov, ow, aqd, gqd, adqd, lams):
        new_lams, imps = [], []
        for bi, (bd, pr) in enumerate(zip(bundles, pre)):
            ln_, lt1, lt2 = lams[bi]
            v_rel = rel_vel(bd, pr, ov, ow, aqd, gqd, adqd)
            vn = ln.dot(v_rel, bd.normal)
            dln = relax * (pr["v_target"] - vn) / pr["k_n"]
            new_ln = ln.maximum(ln_ + dln, 0.0) * pr["af"]
            dln = new_ln - ln_
            vt1 = ln.dot(v_rel, pr["t1"])
            vt2 = ln.dot(v_rel, pr["t2"])
            cap = bd.mu * new_ln
            new_lt1 = ln.clip(lt1 + relax * (-vt1) / pr["k_t1"],
                                  -cap, cap) * pr["af"]
            new_lt2 = ln.clip(lt2 + relax * (-vt2) / pr["k_t2"],
                                  -cap, cap) * pr["af"]
            imps.append(dln[None] * bd.normal
                        + (new_lt1 - lt1)[None] * pr["t1"]
                        + (new_lt2 - lt2)[None] * pr["t2"])
            new_lams.append((new_ln, new_lt1, new_lt2))
        ov, ow, aqd, gqd, adqd = apply_all(ov, ow, aqd, gqd, adqd, imps)
        return ov, ow, aqd, gqd, adqd, new_lams

    ov = [st["obj_vel"][o] for o in range(n_obj)]
    ow = [st["obj_angvel"][o] for o in range(n_obj)]
    adqd = [torch.zeros_like(tpl) for _ in range(n_arm)]
    if lam0 is None:
        lam0 = [(torch.zeros_like(bd.depth),) * 3 for bd in bundles]
    # WARM START (contact_solver.solve lam0 branch): re-mask by the current
    # active set, re-cap friction, apply to the free velocities
    lams, imps0 = [], []
    for bi, (bd, pr) in enumerate(zip(bundles, pre)):
        l0n, l0t1, l0t2 = lam0[bi]
        ln_w = ln.maximum(l0n, 0.0) * pr["af"]
        cap0 = bd.mu * ln_w
        lt1_w = ln.clip(l0t1, -cap0, cap0) * pr["af"]
        lt2_w = ln.clip(l0t2, -cap0, cap0) * pr["af"]
        imps0.append(ln_w[None] * bd.normal + lt1_w[None] * pr["t1"]
                     + lt2_w[None] * pr["t2"])
        lams.append((ln_w, lt1_w, lt2_w))
    ov, ow, aqd, gqd, adqd = apply_all(ov, ow, art_qd0, grip_qd0, adqd,
                                       imps0)
    for _ in range(iters):
        ov, ow, aqd, gqd, adqd, lams = body(ov, ow, aqd, gqd, adqd, lams)
    return ov, ow, aqd, gqd, adqd, lams


# ---------------------------------------------------------------------------
# substep assembly — mirrors envs/physics.physics_substep
# ---------------------------------------------------------------------------

STATE_KEYS = ("q", "qd", "obj_pos", "obj_quat", "obj_vel", "obj_angvel",
              "art_q", "art_qd")


def block_inv_inertia(scene: Scene):
    """Diagonal inverse body inertia of a block, folded in float64."""
    h = np.asarray(scene.block_half, np.float64)
    bm = float(scene.block_mass)
    block_I = bm / 3.0 * np.array([h[1] ** 2 + h[2] ** 2,
                                   h[0] ** 2 + h[2] ** 2,
                                   h[0] ** 2 + h[1] ** 2])
    return [float(1.0 / block_I[j]) for j in range(3)], 1.0 / bm


def art_constants(cfg: EnvConfig, scene: Scene):
    """Per-element free-update constants of the articulated elements, folded
    in float64 and cast to float32: gravity along a prismatic axis, the
    damping factor 1/(1 + dt·c/m), the motor mask and the mass."""
    dt = float(cfg.dt)
    m_eff = scene.art_mass.astype(np.float64)
    g_axis = scene.art_axis.astype(np.float64) @ np.array([0, 0, -9.8])
    rev = np.asarray(scene.art_is_revolute)
    return dict(
        g=np.where(rev, 0.0, g_axis).astype(f32),
        damp=(1.0 / (1.0 + dt * scene.art_damping.astype(np.float64)
                     / m_eff)).astype(f32),
        motor=np.where(scene.art_motor_force > 0, 1.0, 0.0).astype(f32),
        m_eff=m_eff.astype(f32))


def servo_setup(cfg: EnvConfig, tree: KineTree, arm: ArmConfig):
    """Static part of physics.gripper_targets: per-dof (kind, a, b, force)
    where kind 0 = arm servo (target ctrl_q[j]), 1 = gripper (target
    a·amount + b), 2 = mimic follower (target q[a]), 3 = unactuated."""
    n_dof, n_arm = tree.n_dof, arm.n_arm
    rows = [(3, 0.0, 0.0, 0.0) for _ in range(n_dof)]
    for dof, scale, offset, fmax in arm.gripper_dofs:
        rows[dof] = (1, float(scale), float(offset), float(fmax))
    fdof, ldof, ffollow = arm.grip_follower
    if fdof >= 0:
        rows[fdof] = (2, float(ldof), 0.0, float(ffollow))
    for j in range(n_arm):
        rows[j] = (0, float(j), 0.0, float(arm.servo_force))
    if cfg.fixed_gripper:
        rows = rows[:n_arm] + [(k, a, b, 0.0) for k, a, b, _ in rows[n_arm:]]
    return rows


def make_lane_substep(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                      scene: Scene, solve_iters: int = 8):
    dt = float(cfg.dt)
    n_arm = arm.n_arm
    n_dof = tree.n_dof
    n_obj = cfg.num_objects
    servo = servo_setup(cfg, tree, arm)
    artc = art_constants(cfg, scene)
    inv_I_body, inv_m_blk = block_inv_inertia(scene)

    def substep(st: dict, ctrl_q, grip, lam0=None):
        q, qd = st["q"], st["qd"]
        tpl = q[0]
        lower_c = _const(tree.lower, tpl)
        upper_c = _const(tree.upper, tpl)

        # ---- ABA + servos (physics_substep:272-287)
        qdd, D = lane_aba(tree, q, qd)
        qd_free = qd + dt * qdd

        # gripper targets (physics.gripper_targets)
        amount = grip if arm.name == "Panda" else grip - 0.2
        target = []
        for kind, a, b, _ in servo:
            if kind == 0:
                target.append(ctrl_q[int(a)])
            elif kind == 1:
                target.append(a * amount + b)
            elif kind == 2:
                target.append(q[int(a)])
            else:
                target.append(torch.zeros_like(tpl))
        target = torch.stack(target)
        force_c = _const(np.asarray([r[3] for r in servo], f32), tpl)

        # servo_velocity_impulse (dynamics.py:172-187)
        v_star = 0.1 * (target - q) / dt
        imp = ln.clip(D * (v_star - qd_free), -force_c * dt, force_c * dt)
        qd_arm = qd_free + imp / ln.maximum(D, 1e-9)

        # ---- scene free-update (physics_substep:289-305)
        obj_vel = None
        if n_obj:
            g_c = _const(np.array([0, 0, -9.8], f32), tpl)[None]  # (1,3,B)
            obj_vel = st["obj_vel"] + dt * g_c
        atpl = st["art_q"][0]
        art_qd = st["art_qd"] + dt * _const(artc["g"], atpl)
        art_qd = art_qd * _const(artc["damp"], atpl)
        mt_c = _const(scene.art_motor_target, atpl)
        mf_c = _const(scene.art_motor_force, atpl)
        me_c = _const(artc["m_eff"], atpl)
        v_star_a = 0.1 * (mt_c - st["art_q"]) / dt
        imp_a = ln.clip(me_c * (v_star_a - art_qd), -mf_c * dt, mf_c * dt)
        art_qd = art_qd + _const(artc["motor"], atpl) * imp_a / me_c

        # ---- impulse solve on post-servo kinematics (physics_substep:307+)
        kin2 = lane_fk_vel(tree, q, qd_arm)
        pads2 = lane_pad_kinematics(tree, arm, kin2)
        st2 = dict(st)
        st2["art_qd"] = art_qd
        if n_obj:
            st2["obj_vel"] = obj_vel  # post-gravity: the solve's initial ov
        bundles, aux = gather_bundles(cfg, tree, arm, scene, st2, kin2,
                                      qd_arm, *pads2)

        inv_I_world = []
        for o in range(n_obj):
            R = ln.quat_to_mat33(st["obj_quat"][o])          # (3,3,B)
            inv_I_world.append(torch.stack([torch.stack([
                sum(R[r, j] * inv_I_body[j] * R[c, j] for j in range(3))
                for c in range(3)]) for r in range(3)]))

        grip_dofs = aux["grip_dofs"]
        u_g = aux["u_g"]
        inv_m_grip = [1.0 / ln.maximum(D[d], 1e-4) for d in grip_dofs]
        grip_qd0 = [qd_arm[d] for d in grip_dofs]
        inv_D_arm = [1.0 / ln.maximum(D[j], 1e-4) for j in range(n_arm)]

        ov, ow, aqd, gqd, adqd, lams = lane_solve(
            cfg, scene, bundles, st2, inv_I_world, inv_m_blk,
            u_g, inv_m_grip, grip_qd0, art_qd, dt,
            pad_J=aux["pad_J"], inv_D_arm=inv_D_arm, lam0=lam0,
            iters=solve_iters)

        # write solved gripper-driver velocities back + arm-coupled
        # contact correction (row rebuild)
        slot_of = {d: slot for slot, d in enumerate(grip_dofs)}
        qd_arm = torch.stack([
            gqd[slot_of[i]] if i in slot_of
            else (qd_arm[i] + adqd[i] if i < n_arm else qd_arm[i])
            for i in range(n_dof)])

        # ---- integrate (physics_substep:330-354)
        q_next = q + dt * qd_arm
        q_new = ln.clip(q_next, lower_c, upper_c)
        qd_new = torch.where(q_next < lower_c, ln.maximum(qd_arm, 0.0),
                             torch.where(q_next > upper_c,
                                         ln.minimum(qd_arm, 0.0),
                                         qd_arm))
        out = dict(st)
        out["q"] = q_new
        out["qd"] = qd_new
        if n_obj > 0:
            ov_s = torch.stack(ov)
            ow_s = torch.stack(ow)
            out["obj_vel"] = ov_s
            out["obj_angvel"] = ow_s
            out["obj_pos"] = st["obj_pos"] + dt * ov_s
            out["obj_quat"] = torch.stack([
                ln.quat_integrate(st["obj_quat"][o], ow_s[o], dt)
                for o in range(n_obj)])
        art_q = st["art_q"] + dt * aqd
        art_q_c = ln.clip(art_q, _const(scene.art_lower, atpl),
                              _const(scene.art_upper, atpl))
        out["art_qd"] = torch.where(art_q != art_q_c, 0.0, aqd)
        out["art_q"] = art_q_c
        return out, lams

    return substep


def make_lane_sim(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                  scene: Scene, n_substeps: Optional[int] = None,
                  solve_iters: int = 8):
    """Control interval on lane state: n substeps (default cfg.substeps)
    with the contact impulses warm-started from one substep to the next
    (zero on the first)."""
    sub = make_lane_substep(cfg, tree, arm, scene, solve_iters=solve_iters)
    n = n_substeps if n_substeps is not None else cfg.substeps

    def sim(st: dict, ctrl_q, grip):
        lam = None
        for _ in range(n):
            st, lam = sub(st, ctrl_q, grip, lam)
        return st

    return sim


# ---------------------------------------------------------------------------
# packed lane layout (NF, B)
# ---------------------------------------------------------------------------

def _field_rows(cfg: EnvConfig, tree: KineTree):
    n, no = tree.n_dof, cfg.num_objects
    rows = [("q", n), ("qd", n), ("obj_pos", 3 * no), ("obj_quat", 4 * no),
            ("obj_vel", 3 * no), ("obj_angvel", 3 * no), ("art_q", 4),
            ("art_qd", 4)]
    return rows, sum(r for _, r in rows)


def _lanes_from_block(cfg, tree, X):
    """(NF, B) → lane state dict (object fields (no, k, B))."""
    rows, _ = _field_rows(cfg, tree)
    no = cfg.num_objects
    st = {}
    idx = 0
    for name, r in rows:
        if r == 0:          # 0-object envs carry no object fields
            continue
        sl = X[idx:idx + r]
        idx += r
        if name.startswith("obj_"):
            k = 4 if name == "obj_quat" else 3
            st[name] = sl.reshape(no, k, X.shape[1])
        else:
            st[name] = sl
    return st


def _block_from_lanes(cfg, tree, st):
    rows, _ = _field_rows(cfg, tree)
    parts = []
    for name, r in rows:
        if r == 0:
            continue
        v = st[name]
        parts.append(v.reshape(-1, v.shape[-1]))
    return torch.cat(parts, dim=0)


def make_reference_sim(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                       scene: Scene, n_substeps: Optional[int] = None,
                       solve_iters: int = 8):
    """Plain twin of the `sim` kernel: sim_B(X (NF, B), ctrl (n_arm, B),
    grip (B,)) → X'."""
    sim = make_lane_sim(cfg, tree, arm, scene, n_substeps,
                        solve_iters=solve_iters)

    def sim_B(X, ctrl, grip):
        st = _lanes_from_block(cfg, tree, X)
        return _block_from_lanes(cfg, tree, sim(st, ctrl, grip))

    return sim_B


# ---------------------------------------------------------------------------
# lane control: action decode + DLS IK (envs/core.control +
# ops/kinematics.ik_dls)
# ---------------------------------------------------------------------------

def lane_fk_links(tree: KineTree, q):
    """Positions/quats only (IK inner loop)."""
    pos, quat = [], []
    tpl = q[0]
    for i in range(tree.n_dof):
        p = tree.parent[i]
        if p < 0:
            pp = _const(tree.base_pos, tpl)
            pq = _const(tree.base_quat, tpl)
        else:
            pp, pq = pos[p], quat[p]
        jp = pp + ln.quat_rotate(pq, _const(tree.pre_pos[i], tpl))
        jq = ln.quat_multiply(pq, _const(tree.pre_quat[i], tpl))
        a_const = np.asarray(tree.axis[i], f32)
        if tree.jtype[i] == REVOLUTE:
            dq = ln.quat_from_axis_angle(a_const, q[i])
            jq = ln.quat_normalize(ln.quat_multiply(jq, dq))
        else:
            jp = jp + ln.quat_rotate(jq, _const(a_const, tpl) * q[i][None])
        pos.append(jp)
        quat.append(jq)
    return pos, quat


def _lane_site_pose(tree: KineTree, pos, quat, site: int):
    par = tree.site_parent[site]
    tpl = pos[par][0]
    xp = pos[par] + ln.quat_rotate(quat[par],
                                   _const(tree.site_pos[site], tpl))
    xq = ln.quat_multiply(quat[par], _const(tree.site_quat[site], tpl))
    return xp, xq


def _chol6_solve(A, bs):
    """Cholesky-solve the SPD 6x6 lane system for each rhs in bs.
    A: nested 6x6 list; bs: list of 6-vectors (lists). Unrolled."""
    L = [[0.0] * 6 for _ in range(6)]
    for j in range(6):
        acc = A[j][j]
        for k in range(j):
            acc = _acc(acc, -_mul(L[j][k], L[j][k]))
        Ljj = torch.sqrt(ln.maximum(acc, 1e-12))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, 6):
            acc = A[i][j]
            for k in range(j):
                acc = _acc(acc, -_mul(L[i][k], L[j][k]))
            L[i][j] = _mul(acc, inv)
    outs = []
    for b in bs:
        y = [0.0] * 6
        for i in range(6):
            acc = b[i]
            for k in range(i):
                acc = _acc(acc, -_mul(L[i][k], y[k]))
            y[i] = acc / L[i][i]
        x = [0.0] * 6
        for i in range(5, -1, -1):
            acc = y[i]
            for k in range(i + 1, 6):
                acc = _acc(acc, -_mul(L[k][i], x[k]))
            x[i] = acc / L[i][i]
        outs.append(x)
    return outs


def lane_ik_dls(tree: KineTree, arm: ArmConfig, q0, target_pos, target_quat,
                iters: int, damping: float = 0.05, null_gain: float = 0.05):
    """Mirror of kinematics.ik_dls on lane state (only the first n_arm dofs
    move). q0: (n_dof, B); targets: (3/4, B). Returns q in q0's dtype.

    The iteration runs in float64 whatever the inputs' dtype, as the
    kernel's does: where a joint limit or the step clamp cuts it (the Panda
    at the edge of its reach) it is ill-conditioned, and two float32 orders
    of the same sums part there by up to 1e-2 rad."""
    dtype = q0.dtype
    q0, target_pos, target_quat = (
        q0.double(), target_pos.double(), target_quat.double())
    n_active = arm.n_arm
    site = arm.ee_site
    rest = np.zeros(tree.n_dof, f32)
    rest[:n_active] = np.asarray(arm.rest_pose, f32)
    anc = _ancestors(tree, tree.site_parent[site])
    lower_c = _const(tree.lower, q0[0])
    upper_c = _const(tree.upper, q0[0])
    q = q0
    for _ in range(iters):
        pos, quat = lane_fk_links(tree, q)
        xp, xq = _lane_site_pose(tree, pos, quat, site)
        # orientation error (kinematics._orientation_error)
        dq4 = ln.quat_multiply(target_quat, ln.quat_conjugate(xq))
        sgn = torch.sign(dq4[3] + 1e-12)
        err = [target_pos[0] - xp[0], target_pos[1] - xp[1],
               target_pos[2] - xp[2],
               2.0 * dq4[0] * sgn, 2.0 * dq4[1] * sgn, 2.0 * dq4[2] * sgn]
        # jacobian columns (kinematics.jacobian_site), active dofs only
        cols = []
        for i in range(n_active):
            if i not in anc:
                cols.append(None)
                continue
            a_w = ln.quat_rotate(quat[i], _const(tree.axis[i], xp[0]))
            if tree.jtype[i] == REVOLUTE:
                lin = ln.cross(a_w, xp - pos[i])
                col = [lin[0], lin[1], lin[2], a_w[0], a_w[1], a_w[2]]
            else:
                col = [a_w[0], a_w[1], a_w[2], 0.0, 0.0, 0.0]
            cols.append(col)
        # JJt + damping^2 I (6x6)
        A = [[0.0] * 6 for _ in range(6)]
        for r in range(6):
            for c in range(r, 6):
                acc = (damping * damping) if r == c else 0.0
                for col in cols:
                    if col is not None:
                        acc = _acc(acc, _mul(col[r], col[c]))
                A[r][c] = acc
                A[c][r] = acc
        # J @ dq_null
        dq_null = [null_gain * (float(rest[i]) - q[i])
                   for i in range(n_active)]
        Jdn = [sum6(_mul(cols[i][r], dq_null[i])
                    for i in range(n_active) if cols[i] is not None)
               for r in range(6)]
        w_err, w_null = _chol6_solve(A, [err, Jdn])
        dq_rows = []
        for i in range(tree.n_dof):
            if i < n_active:
                if cols[i] is None:
                    d = dq_null[i]
                else:
                    jt_err = sum6(_mul(cols[i][r], w_err[r])
                                  for r in range(6))
                    jt_nul = sum6(_mul(cols[i][r], w_null[r])
                                  for r in range(6))
                    d = _acc(_acc(jt_err, dq_null[i]), -jt_nul)
                d = ln.clip(_lane_of(d, q[0]), -0.5, 0.5)
            else:
                d = torch.zeros_like(q[0])
            dq_rows.append(d)
        q = ln.clip(q + torch.stack(dq_rows), lower_c, upper_c)
    return q.to(dtype)


def lane_quat_from_euler(rpy):
    r, p, y = rpy[0] * 0.5, rpy[1] * 0.5, rpy[2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp_ = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([sr * cp * cy - cr * sp_ * sy,
                        cr * sp_ * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp_ * cy,
                        cr * cp * cy + sr * sp_ * sy])


def lane_quat_to_euler(qv):
    x, y, z, w = qv[0], qv[1], qv[2], qv[3]
    sinr = 2.0 * (w * x + y * z)
    cosr = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr, cosr)
    sinp = ln.clip(2.0 * (w * y - z * x), -1.0 + 1e-7, 1.0 - 1e-7)
    pitch = torch.asin(sinp)
    siny = 2.0 * (w * z + x * y)
    cosy = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny, cosy)
    return torch.stack([roll, pitch, yaw])


def default_ik_iters(arm: ArmConfig) -> int:
    return 16 if arm.name == "Panda" else 24


def make_lane_control(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                      ik_iters: Optional[int] = None):
    """action (A, B) + state q (n_dof, B) → (ctrl targets (n_arm, B),
    grip (B,)) in q's dtype. Mirrors envs/core.control, computed in
    float64 as the kernel's control is (the decode feeds lane_ik_dls's
    ill-conditioned iteration its target: see there)."""
    at = cfg.action_type
    n_arm = arm.n_arm
    iters = ik_iters if ik_iters is not None else default_ik_iters(arm)

    def control(q, action):
        dtype = q.dtype
        q, action = q.double(), action.double()
        tpl = q[0]
        high = _const(np.asarray(cfg.action_high, f32), tpl)
        action = ln.clip(action, -high, high)
        grip = action[action.shape[0] - 1]
        pos_l, quat_l = lane_fk_links(tree, q)
        ee_pos, ee_quat = _lane_site_pose(tree, pos_l, quat_l, arm.ee_site)
        identity = _const(np.array([0, 0, 0, 1], f32), tpl)

        if at == "relative_joints":
            targets = q[:n_arm] + action[:n_arm]
        elif at == "absolute_joints":
            targets = action[:n_arm]
        else:
            if at == "absolute_quat":
                pos = action[0:3]
                quat = (ln.quat_normalize(action[3:7]) if cfg.use_orientation
                        else identity)
            elif at == "relative_quat":
                # the reference adds quaternions componentwise
                pos = action[0:3] + ee_pos
                quat = ln.quat_normalize(action[3:7] + ee_quat)
            elif at == "absolute_rpy":
                pos = action[0:3]
                quat = lane_quat_from_euler(action[3:6])
            elif at == "relative_rpy":
                pos = action[0:3] + ee_pos
                quat = lane_quat_from_euler(
                    lane_quat_to_euler(ee_quat) + action[3:6])
            else:
                pos = action[0:3] + ee_pos
                if cfg.use_orientation:
                    quat = lane_quat_from_euler(
                        lane_quat_to_euler(ee_quat) + action[3:6])
                else:
                    quat = identity
            sol = lane_ik_dls(tree, arm, q, pos, quat, iters)
            targets = sol[:n_arm]

        ll = _const(np.asarray(arm.ctrl_lower, f32), tpl)
        ul = _const(np.asarray(arm.ctrl_upper, f32), tpl)
        inc = _const(np.asarray(arm.rate_limit, f32), tpl)
        targets = ln.clip(targets, ll, ul)
        cur = q[:n_arm]
        targets = ln.clip(targets, cur - inc, cur + inc)
        return targets.to(dtype), grip.to(dtype)

    return control


def make_reference_step(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                        scene: Scene, n_substeps: Optional[int] = None,
                        ik_iters: Optional[int] = None,
                        solve_iters: int = 8, with_ctrl: bool = False):
    """Plain twin of the `step` kernel: step_B(X (NF, B), actions (A, B))
    → X', or with with_ctrl (X', C (n_arm + 1, B)): the servo targets and
    the gripper command control chose. ik_iters/solve_iters below the
    defaults give the cheaper preview model, not the reference-parity env
    step."""
    sim = make_lane_sim(cfg, tree, arm, scene, n_substeps,
                        solve_iters=solve_iters)
    control = make_lane_control(cfg, tree, arm, ik_iters=ik_iters)

    def step_B(X, actions):
        st = _lanes_from_block(cfg, tree, X)
        ctrl, grip = control(st["q"], actions)
        X2 = _block_from_lanes(cfg, tree, sim(st, ctrl, grip))
        if with_ctrl:
            return X2, torch.cat([ctrl, grip[None]], dim=0)
        return X2

    return step_B


def ag_layout(cfg: EnvConfig, tree: KineTree, with_ee: bool = False):
    """(with_ee, ag_dim) of the per-step achieved goal of the rollout."""
    no = cfg.num_objects
    with_ee = with_ee and (no > 0 or cfg.play)   # reach ag already IS ee
    ag_dim = ((7 * no + 4) if cfg.play else
              (((7 if cfg.use_orientation else 3) * no) if no else 3)) \
        + (3 if with_ee else 0)
    return with_ee, ag_dim


def make_lane_ag(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                 with_ee: bool = False):
    """Achieved goal (ag_dim, B) out of the packed state X (NF, B): object
    pose rows, the articulated rows with dial_to_0_1_range (its precedence
    bug included), lane-FK ee position for reach envs, and the optional
    ee tail. Mirrors make_pallas_rollout's ag_of."""
    n, no = tree.n_dof, cfg.num_objects
    with_ee, _ = ag_layout(cfg, tree, with_ee)
    pos0 = 2 * n
    quat0 = pos0 + 3 * no
    art0 = quat0 + 4 * no + 6 * no

    def ee_of(X):
        pos_l, quat_l = lane_fk_links(tree, X[0:n])
        return _lane_site_pose(tree, pos_l, quat_l, arm.ee_site)[0]

    def ag_of(X):
        if no == 0 and not cfg.play:
            return ee_of(X)
        parts = []
        for o in range(no):
            parts.append(X[pos0 + 3 * o: pos0 + 3 * (o + 1)])
            if cfg.play or cfg.use_orientation:
                parts.append(X[quat0 + 4 * o: quat0 + 4 * (o + 1)])
        if cfg.play:
            art = X[art0:art0 + 4]
            # python floor-mod: torch.remainder, never fmod
            dial = torch.remainder(art[3], 2.0) * np.pi / (2.2 * np.pi)
            parts.append(torch.stack([art[0], art[1], art[2], dial]))
        if with_ee:
            parts.append(ee_of(X))
        return torch.cat(parts, dim=0)

    return ag_of


def make_reference_rollout(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                           scene: Scene, horizon: int,
                           n_substeps: Optional[int] = None,
                           ik_iters: Optional[int] = None,
                           solve_iters: int = 8, with_ee: bool = False):
    """Plain twin of the `rollout` kernel: roll_B(X (NF, B), actions
    (H, A, B)) → (X', ags (H, ag_dim, B))."""
    step = make_reference_step(cfg, tree, arm, scene, n_substeps=n_substeps,
                               ik_iters=ik_iters, solve_iters=solve_iters)
    ag_of = make_lane_ag(cfg, tree, arm, with_ee)

    def roll_B(X, actions):
        ags = []
        for h in range(horizon):
            X = step(X, actions[h])
            ags.append(ag_of(X))
        return X, torch.stack(ags)

    return roll_B



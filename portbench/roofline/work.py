"""The operations and bytes a fused control step needs, and the least time
an H100 could take for them.

A frozen copy of the port's `chip_smoke.py::work` / `bound_ms` and of the
model tables they read (`ops/cuda_build.py::model_values` / `row_table`),
counted from the model's static structure (link types, ancestors, the
contact row table) and not from whatever implements it: a later change to
the kernel does not change what the work is. Everything here reads the
benchmark's own frozen model (portbench/reference), none of the program.

An add, multiply, division, square root, sin or cos counts 1 (an FMA 2);
compares, selects, min/max and clips count 0. Control (action decode, DLS
IK) runs in float64, the substeps in float32. Each input byte is read once
and each output byte written once.
"""
from __future__ import annotations

from ..reference import twin as fs

# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): float32 and float64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_FLOPS64 = 34e12
PEAK_BYTES = 3.35e12

FS_MAX_ARM = 7              # csrc/fused_step.cu's FS_MAX_ARM: pad_anc stride

# contact row kinds, in the kernel's numbering
ROW_FLOOR, ROW_STATIC, ROW_ART, ROW_PAD_BLOCK = 0, 1, 2, 3
ROW_BB, ROW_PAD_ART, ROW_PAD_FLOOR, ROW_PAD_STATIC = 4, 5, 6, 7

# FLOPs of the kernel body's primitives
QROT, QMUL, QNORM, QAXIS, CROSS, DOT, Q2M, M33V = 38, 28, 13, 6, 9, 5, 30, 15
M6V, BUILD_X = 72, 54
POINTS_OBOX = 3 + QROT + 3 + QROT + 30 + QROT + 3 + QROT     # 191
SPHERE_OBOX = 3 + QROT + 35 + QROT + 3 + QROT + 3            # 158


def row_table(cfg, scene, pad_slot) -> list:
    """The model's contact rows in gather_bundles' order, one dict each:
    kind, idx (block corner or pad), o (block), and the solver indices a,
    b, k, g, pj, vk (-1 where absent)."""
    rows = []

    def put(kind, idx=0, o=0, a=-1, b=-1, k=-1, g=-1, pj=-1, vk=-1):
        rows.append(dict(kind=kind, idx=idx, o=o, a=a, b=b, k=k, g=g, pj=pj,
                         vk=vk))

    arts = [k for k in range(4)
            if scene.has_articulated and fs._real_boxes(scene, k)]
    n_static = int(scene.static_pos.shape[0])
    pads = range(len(pad_slot))
    for o in range(cfg.num_objects):
        for c in range(8):
            put(ROW_FLOOR, c, o, a=o)
        if n_static:
            for c in range(8):
                put(ROW_STATIC, c, o, a=o)
        for k in arts:
            for c in range(8):
                put(ROW_ART, c, o, a=o, k=k)
        for p in pads:
            put(ROW_PAD_BLOCK, p, o, a=o, g=pad_slot[p], vk=p)
    if cfg.num_objects == 2:
        for c in range(8):
            put(ROW_BB, c, 0, a=0, b=1)
    for k in arts:
        for p in pads:
            put(ROW_PAD_ART, p, k=k, g=pad_slot[p], pj=p, vk=p)
    for p in pads:
        put(ROW_PAD_FLOOR, p, g=pad_slot[p], pj=p, vk=p)
        if n_static:
            put(ROW_PAD_STATIC, p, g=pad_slot[p], pj=p, vk=p)
    return rows


def model_values(cfg, tree, arm, scene) -> dict:
    """The static model sizes `work` reads (the subset of the kernel's Model
    struct that counts operations)."""
    n, na = tree.n_dof, arm.n_arm
    v = dict(n_dof=n, n_arm=na, n_obj=cfg.num_objects,
             n_static=int(scene.static_pos.shape[0]), n_sub=cfg.substeps,
             action_dim=cfg.action_dim)
    v["parent"] = list(tree.parent)
    v["revolute"] = [int(t == fs.REVOLUTE) for t in tree.jtype]
    anc = fs._ancestors(tree, tree.site_parent[arm.ee_site])
    v["ee_anc"] = [int(i in anc) for i in range(na)]
    pad_par = [tree.site_parent[s] for s, _, _ in arm.pad_spheres]
    grip_dofs = tuple(dict.fromkeys(pad_par))
    v["n_grip"] = len(grip_dofs)
    v["pad_slot"] = [grip_dofs.index(d) for d in pad_par]
    v["pad_anc"] = [int(j < na and j in fs._ancestors(tree, p))
                    for p in pad_par for j in range(FS_MAX_ARM)]
    v["art_nb"] = [len(fs._real_boxes(scene, k)) for k in range(4)]
    return v


def per_env_step(cfg, tree, arm, scene, ik_iters=None, solve_iters=8):
    """(float32 FLOPs, float64 FLOPs) of one env's control step: control
    (float64) and cfg.substeps substeps (float32), ags not included."""
    ik = fs.default_ik_iters(arm) if ik_iters is None else ik_iters
    v = model_values(cfg, tree, arm, scene)
    n, na, no = v["n_dof"], v["n_arm"], v["n_obj"]
    rev, par = v["revolute"][:n], v["parent"][:n]
    ns, nb = v["n_static"], v["art_nb"]
    anc = [sum(v["pad_anc"][p * FS_MAX_ARM:p * FS_MAX_ARM + na])
           for p in range(4)]
    n_ee = sum(v["ee_anc"][:na])
    fk_pos = sum(QROT + 3 + QMUL + (QAXIS + QMUL + QNORM if r else 3 + QROT
                                    + 3) for r in rev)
    fk_vel = fk_pos + n * (3 + CROSS + 3 + QROT + 6)
    site = QROT + 3 + QMUL
    aba = sum((QAXIS + QMUL + Q2M if r else 3) + BUILD_X
              + (M6V if p >= 0 else 0) + 12 + 3 * CROSS + 3 + M6V
              + 3 * CROSS + 3                       # forward: v, c, pA
              + M6V + 24 + 4                        # U, D, u
              + (108 + 1 + M6V + 19 + BUILD_X + 432 + 468 + M6V + 6
                 if p >= 0 else 0)                  # Ia, pa, X^T Ia X
              + BUILD_X + M6V + 6 + 12 + 2 + 12     # accelerations
              for r, p in zip(rev, par))
    context = (4 * (QROT + 3 + QMUL + QROT + 3 + 3 + CROSS + 3)   # pads
               + no * (Q2M + 72) + v["n_grip"] * (QROT + 1) + 4 * 6
               + (QROT + 3 + CROSS) * sum(anc) + na + 15 * n + 60)
    rows = row_table(cfg, scene, v["pad_slot"])
    corner = 3 + QROT + 3
    geo = {ROW_FLOOR: lambda r: corner + 1,
           ROW_STATIC: lambda r: corner + ns * 36,
           ROW_ART: lambda r: corner + QAXIS
           + nb[r["k"]] * (QROT + 3 + POINTS_OBOX),
           ROW_PAD_BLOCK: lambda r: SPHERE_OBOX,
           ROW_BB: lambda r: corner + POINTS_OBOX,
           ROW_PAD_ART: lambda r: QAXIS
           + nb[r["k"]] * (QROT + 3 + SPHERE_OBOX),
           ROW_PAD_FLOOR: lambda r: 8,
           ROW_PAD_STATIC: lambda r: ns * 38}
    gather = sum(geo[r["kind"]](r) + 38 for r in rows)

    def has(r, key):
        return r[key] >= 0

    def pj_anc(r):
        return anc[r["pj"]] if has(r, "pj") else 0

    kdir = sum(3 * (36 * has(r, "a") + 36 * has(r, "b") + 25 * has(r, "k")
                    + 9 * has(r, "g") + 9 * pj_anc(r)) for r in rows)
    accum = sum(18 * has(r, "a") + 18 * has(r, "b") + 19 * has(r, "k")
                + 6 * has(r, "g") + 6 * pj_anc(r) for r in rows)
    apply_ = no * 24 + 8 + 2 * v["n_grip"] + 2 * na + 6
    warm = 25 * len(rows) + accum + apply_
    sweep = sum(50 + 15 * (has(r, "a") or has(r, "k")) + 15 * has(r, "b")
                + 12 * has(r, "k") + 6 * has(r, "g") + 3 * has(r, "vk") + 3
                + 6 * pj_anc(r) for r in rows) + accum + apply_
    integrate = 6 * n + no * (9 + 12 + QMUL + QNORM) + 16
    substep = (aba + fk_vel + context + gather + kdir + warm
               + solve_iters * sweep + integrate)
    ik_iter = (fk_pos + site + QMUL + 10 + (QROT + 3 + CROSS) * n_ee
               + 42 * n_ee + 6 + 12 * n_ee + 2 * na + 290 + 30 * n_ee)
    control = 2 * v["action_dim"] + fk_pos + site + 60 + ik * ik_iter + 4 * na
    return v["n_sub"] * substep, control


def rollout_work(cfg, tree, arm, scene, B, H, ik_iters=None, solve_iters=8,
                 with_ee=False):
    """(float32 FLOPs, float64 FLOPs, bytes) of one `fs_rollout` launch of
    B envs over H control steps: the packed state read and written once,
    the actions read once, the per-step achieved goals written once."""
    sim, control = per_env_step(cfg, tree, arm, scene, ik_iters, solve_iters)
    _, nf = fs._field_rows(cfg, tree)
    _, ag = fs.ag_layout(cfg, tree, with_ee)
    A = cfg.action_dim
    return (B * H * (sim + 4), B * H * control,
            4 * B * (2 * nf + H * (A + ag)))


def step_work(cfg, tree, arm, scene, B, ik_iters=None, solve_iters=8):
    """(float32 FLOPs, float64 FLOPs, bytes) of one `fs_step` launch."""
    sim, control = per_env_step(cfg, tree, arm, scene, ik_iters, solve_iters)
    _, nf = fs._field_rows(cfg, tree)
    return B * sim, B * control, 4 * B * (2 * nf + cfg.action_dim)


def bound_ms(flops, flops64, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the float32 and float64 pipes (separate units) each at its peak."""
    t_ops = max(flops / PEAK_FLOPS, flops64 / PEAK_FLOPS64)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")

"""Build, load and feed the hand-written CUDA kernel csrc/fused_step.cu.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, from the sources in this package only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libfused_step.so \
         roboticsplayroompybullet_torch/csrc/fused_step.cu

It is rebuilt when the source's sha256 changes (build/torch_kernels/
libfused_step.sha256) and loaded with ctypes. Nothing here imports a
compiler or touches the card at import time.

The model constants go to the kernel as one POD struct (`Model` in the
.cu). Its field list is parsed from the source (FS_MODEL_FIELDS), laid out
with ctypes, and checked field by field against the offsets the compiled
library reports, so the two sides cannot drift apart.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..models.kinetree import REVOLUTE

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(os.path.dirname(PKG), "build", "torch_kernels")
LIB = os.path.join(BUILD_DIR, "libfused_step.so")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

ACTION_TYPES = {"absolute_quat": 0, "relative_quat": 1,
                "relative_joints": 2, "absolute_joints": 3,
                "absolute_rpy": 4, "relative_rpy": 5}
ACTION_REL_CART = 6           # any other action_type: relative cartesian

# what the last build did: seconds and the compiler's output
BUILD_INFO: dict = {}
_LOCK = threading.Lock()
_LIBS: dict = {}


def _source_text(source: str = SOURCE) -> str:
    with open(source) as f:
        return f.read()


def _defines(src: str) -> dict:
    """The integer #defines FS_* of the source, expressions evaluated in
    order (a name defined twice, under #ifdef, keeps its last value)."""
    out = {}
    text = src.replace("\\\n", " ")
    for name, expr in re.findall(r"^#define\s+(FS_\w+)[ \t]+([^\n]+)$", text,
                                 re.M):
        expr = re.sub(r"\bFS_\w+\b",
                      lambda t: str(out.get(t.group(0), t.group(0))), expr)
        if re.fullmatch(r"[\d\s()+*/-]+", expr):
            out[name] = int(eval(expr.replace("/", "//"),
                                 {"__builtins__": {}}))
    return out


def _fields(src: str, macro: str):
    m = re.search(r"#define " + macro + r"\((?:S, )?A\)(.*?)\n\n", src, re.S)
    if m is None:
        raise RuntimeError(macro + " not found in the kernel source")
    body = m.group(1).replace("\\\n", " ")
    consts = _defines(src)
    fields = []
    for kind, typ, name, count in re.findall(
            r"\b([SA])\((int|float|double),\s*(\w+)(?:,\s*([^)]+))?\)",
            body):
        n = 1
        if kind == "A":
            expr = re.sub(r"\bFS_\w+\b", lambda t: str(consts[t.group(0)]),
                          count)
            n = int(eval(expr, {"__builtins__": {}}))
        fields.append((name, typ, n, kind))
    return fields


def model_fields(src: str = None):
    """[(name, 'int'|'float', count, 'S'|'A')] of the Model struct, in
    order."""
    return _fields(src if src is not None else _source_text(),
                   "FS_MODEL_FIELDS")


def row_capacity(src: str = None) -> int:
    """Contact rows one team of FS_TEAM lanes holds: FS_SLOTS per lane."""
    c = _defines(src if src is not None else _source_text())
    return -(-c["FS_MAX_ROWS"] // c["FS_TEAM"]) * c["FS_TEAM"]


def launch_smem_bytes(src: str = None) -> int:
    """Dynamic shared memory of one block, as the launchers ask for it: the
    Model rounded up to 16 bytes, then FS_ENVS EnvSh."""
    src = src if src is not None else _source_text()
    model = ctypes.sizeof(_struct_type(model_fields(src)))
    env = ctypes.sizeof(_struct_type(_fields(src, "FS_ENV_FIELDS")))
    return -(-model // 16) * 16 + _defines(src)["FS_ENVS"] * env


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "double": ctypes.c_double}


def _struct_type(fields):
    cfields = []
    for name, typ, n, kind in fields:
        base = _CTYPES[typ]
        cfields.append((name, base if kind == "S" else base * n))
    return type("Model", (ctypes.Structure,), {"_fields_": cfields})


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel is built on a machine "
                       "with the CUDA toolkit")


def _lib_path(source: str) -> str:
    if os.path.abspath(source) == SOURCE:
        return LIB
    stem = os.path.splitext(os.path.basename(source))[0]
    digest = hashlib.sha256(os.path.abspath(source).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:12]}.so")


def build(force: bool = False, source: str = SOURCE) -> str:
    """Compile the kernel library if its source changed; return its path.
    `source` names another copy of the kernel (tools/time_fused_kernel.py
    times two side by side); it builds into its own library."""
    src = _source_text(source)
    digest = hashlib.sha256(src.encode()).hexdigest()
    lib_path = _lib_path(source)
    stamp = os.path.splitext(lib_path)[0] + ".sha256"
    if not force and os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                BUILD_INFO.update(seconds=0.0, cached=True)
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp, source]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.time() - t0
    log = res.stdout + res.stderr
    with open(os.path.splitext(lib_path)[0] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    BUILD_INFO.update(seconds=secs, cached=False, log=log)
    return lib_path


def library(source: str = SOURCE):
    """The loaded kernel library of `source` (built on first use)."""
    source = os.path.abspath(source)
    with _LOCK:
        if source not in _LIBS:
            lib = ctypes.CDLL(build(source=source))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.fs_model_layout.argtypes = [ctypes.POINTER(I), I]
            lib.fs_model_layout.restype = I
            lib.fs_sim.argtypes = [P, P, P, P, P, I, P]
            lib.fs_step.argtypes = [P, P, P, P, P, I, P]
            lib.fs_rollout.argtypes = [P, P, P, P, P, I, I, P]
            for f in (lib.fs_sim, lib.fs_step, lib.fs_rollout):
                f.restype = I
            lib.fs_error_string.argtypes = [I]
            lib.fs_error_string.restype = ctypes.c_char_p
            _check_layout(lib, source)
            _LIBS[source] = lib
    return _LIBS[source]


def _check_layout(lib, source: str = SOURCE):
    fields = model_fields(_source_text(source))
    S = _struct_type(fields)
    offs = (ctypes.c_int * (len(fields) + 1))()
    n = lib.fs_model_layout(offs, len(fields) + 1)
    if n != len(fields) + 1:
        raise RuntimeError(f"Model has {n - 1} fields in the library, "
                           f"{len(fields)} parsed from the source")
    for i, (name, _, _, _) in enumerate(fields):
        if getattr(S, name).offset != offs[i]:
            raise RuntimeError(f"Model.{name}: ctypes offset "
                               f"{getattr(S, name).offset} != {offs[i]}")
    if ctypes.sizeof(S) != offs[len(fields)]:
        raise RuntimeError("sizeof(Model) differs between ctypes and nvcc")


# ---------------------------------------------------------------------------
# model constants
# ---------------------------------------------------------------------------

# contact-row kinds of the kernel (FS_ROW_*), in gather_bundles' order
(ROW_FLOOR, ROW_STATIC, ROW_ART, ROW_PAD_BLOCK, ROW_BB, ROW_PAD_ART,
 ROW_PAD_FLOOR, ROW_PAD_STATIC) = range(8)


def row_table(cfg, scene, pad_slot) -> list:
    """The model's contact rows in gather_bundles' order, one dict each:
    kind, idx (block corner or pad), o (block), and the solver indices a,
    b, k, g, pj, vk (-1 where absent)."""
    rows = []

    def put(kind, idx=0, o=0, a=-1, b=-1, k=-1, g=-1, pj=-1, vk=-1):
        rows.append(dict(kind=kind, idx=idx, o=o, a=a, b=b, k=k, g=g, pj=pj,
                         vk=vk))

    from . import fused_step as fs
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


def row_code(r: dict) -> int:
    """One row packed as the kernel's row_code (bits in fused_step.cu)."""
    return (r["kind"] | r["idx"] << 3 | r["o"] << 6 | (r["a"] + 1) << 7
            | (r["b"] + 1) << 9 | (r["k"] + 1) << 11 | (r["g"] + 1) << 14
            | (r["pj"] + 1) << 16 | (r["vk"] + 1) << 19)

def model_values(cfg, tree, arm, scene, n_substeps: int, ik_iters: int,
                 solve_iters: int, with_ee: bool) -> dict:
    """Every Model field as python/numpy values, constants folded in float64
    where the JAX trace folds them (see ops/fused_step.py)."""
    from . import fused_step as fs

    n, na, no = tree.n_dof, arm.n_arm, cfg.num_objects
    _, nf = fs._field_rows(cfg, tree)
    with_ee, ag_dim = fs.ag_layout(cfg, tree, with_ee)
    v = dict(n_dof=n, n_arm=na, n_obj=no,
             n_static=int(scene.static_pos.shape[0]), n_sub=n_substeps,
             solve_iters=solve_iters, ik_iters=ik_iters,
             action_type=ACTION_TYPES.get(cfg.action_type, ACTION_REL_CART),
             use_orientation=int(cfg.use_orientation), play=int(cfg.play),
             with_ee=int(with_ee), has_art=int(scene.has_articulated),
             nf=nf, action_dim=cfg.action_dim, ag_dim=ag_dim,
             panda=int(arm.name == "Panda"))
    v["parent"] = list(tree.parent)
    v["revolute"] = [int(t == REVOLUTE) for t in tree.jtype]
    ee_par = tree.site_parent[arm.ee_site]
    v["ee_parent"] = ee_par
    anc = fs._ancestors(tree, ee_par)
    v["ee_anc"] = [int(i in anc) for i in range(na)]
    pad_par = [tree.site_parent[s] for s, _, _ in arm.pad_spheres]
    grip_dofs = tuple(dict.fromkeys(pad_par))
    v["n_grip"] = len(grip_dofs)
    v["grip_dof"] = list(grip_dofs)
    v["pad_parent"] = pad_par
    v["pad_slot"] = [grip_dofs.index(d) for d in pad_par]
    max_arm = _defines(_source_text())["FS_MAX_ARM"]
    v["pad_anc"] = [int(j < na and j in fs._ancestors(tree, p))
                    for p in pad_par for j in range(max_arm)]
    servo = fs.servo_setup(cfg, tree, arm)
    v["servo_kind"] = [r[0] for r in servo]
    v["servo_a"] = [r[1] for r in servo]
    v["servo_b"] = [r[2] for r in servo]
    v["servo_f"] = [r[3] for r in servo]
    v["art_rev"] = [int(r) for r in scene.art_is_revolute]
    real = [fs._real_boxes(scene, k) for k in range(4)]
    v["art_nb"] = [len(r) for r in real]
    rows = row_table(cfg, scene, v["pad_slot"])
    v["n_rows"] = len(rows)
    v["row_code"] = [row_code(r) for r in rows]

    v["dt"] = float(cfg.dt)
    v["half_dt"] = float(cfg.dt) * 0.5
    v["plane_z"] = float(scene.plane_z)
    inv_I, inv_m = fs.block_inv_inertia(scene)
    v["inv_m_blk"] = inv_m
    v["block_inv_I"] = inv_I
    v["mu_world"] = float(scene.block_fric) * 0.5
    v["mu_pad"] = float(scene.block_fric)
    v["mu_art"] = 0.5 * float(scene.block_fric)
    v["mu_bb"] = float(scene.block_fric)
    v["dial_mul"] = math.pi
    v["dial_div"] = 2.2 * math.pi

    v["base_pos"] = tree.base_pos
    v["base_quat"] = tree.base_quat
    v["pre_pos"] = tree.pre_pos
    v["pre_quat"] = tree.pre_quat
    v["axis"] = tree.axis
    v["lower"] = tree.lower
    v["upper"] = tree.upper
    v["damping"] = tree.damping
    v["inertia6"] = np.stack([fs._np_spatial_inertia(
        float(tree.mass[i]), np.asarray(tree.com[i], np.float64),
        np.asarray(tree.inertia[i], np.float64)) for i in range(n)])
    pris_E = np.zeros((n, 9), np.float32)
    pris_rax = np.zeros((n, 3), np.float32)
    for i in range(n):
        if tree.jtype[i] != REVOLUTE:
            Xi, _ = fs._joint_transform(tree, i, 0.0)
            pris_E[i] = [Xi[r][c] for r in range(3) for c in range(3)]
            pris_rax[i] = fs._np_quat_rotate(tree.pre_quat[i], tree.axis[i])
    v["pris_E"] = pris_E
    v["pris_rax"] = pris_rax
    v["a_base"] = fs.base_gravity_accel(tree)
    v["ee_pos"] = tree.site_pos[arm.ee_site]
    v["ee_quat"] = tree.site_quat[arm.ee_site]
    v["pad_site_pos"] = np.stack([tree.site_pos[s] for s, _, _ in arm.pad_spheres])
    v["pad_site_quat"] = np.stack([tree.site_quat[s] for s, _, _ in arm.pad_spheres])
    v["pad_off"] = np.array([o for _, o, _ in arm.pad_spheres], np.float32)
    v["pad_r"] = [float(r) for _, _, r in arm.pad_spheres]

    v["action_high"] = list(cfg.action_high)
    v["ctrl_lower"] = list(arm.ctrl_lower)
    v["ctrl_upper"] = list(arm.ctrl_upper)
    v["rate_limit"] = list(arm.rate_limit)
    v["rest"] = list(arm.rest_pose)

    v["static_pos"] = scene.static_pos
    v["static_half"] = scene.static_half
    v["block_half"] = scene.block_half
    v["art_anchor"] = scene.art_anchor
    v["art_axis"] = scene.art_axis
    bp = np.zeros((4, 6, 3), np.float32)
    bh = np.zeros((4, 6, 3), np.float32)
    for k in range(4):
        for j, b in enumerate(real[k]):
            bp[k, j] = scene.art_boxes_pos[k, b]
            bh[k, j] = scene.art_boxes_half[k, b]
    v["art_box_pos"] = bp
    v["art_box_half"] = bh
    v["art_lower"] = scene.art_lower
    v["art_upper"] = scene.art_upper
    v["art_motor_target"] = scene.art_motor_target
    v["art_motor_force"] = scene.art_motor_force
    artc = fs.art_constants(cfg, scene)
    v["art_g"] = artc["g"]
    v["art_damp"] = artc["damp"]
    v["art_motor"] = artc["motor"]
    v["art_m"] = artc["m_eff"]
    v["inv_m_art"] = [1.0 / float(scene.art_mass[k]) for k in range(4)]
    return v


def model_bytes(values: dict, source: str = SOURCE) -> bytes:
    """Pack the Model struct of `source`; every field must be given and
    fit."""
    fields = model_fields(_source_text(source))
    S = _struct_type(fields)
    s = S()
    names = {f[0] for f in fields}
    extra = set(values) - names
    if extra:
        raise KeyError(f"values for unknown Model fields: {sorted(extra)}")
    for name, typ, n, kind in fields:
        if name not in values:
            raise KeyError(f"Model.{name} not given")
        val = values[name]
        if kind == "S":
            setattr(s, name, int(val) if typ == "int" else float(val))
            continue
        a = np.asarray(val, np.int64 if typ == "int" else np.float32).ravel()
        if a.size > n:
            raise ValueError(f"Model.{name}: {a.size} values > {n}")
        arr = getattr(s, name)
        for i, x in enumerate(a):
            arr[i] = int(x) if typ == "int" else float(x)
    return ctypes.string_at(ctypes.addressof(s), ctypes.sizeof(s))


class KernelModel:
    """One model's constants on the card plus the launchers."""

    def __init__(self, cfg, tree, arm, scene, n_substeps: int, ik_iters: int,
                 solve_iters: int, with_ee: bool = False,
                 source: str = SOURCE):
        v = model_values(cfg, tree, arm, scene, n_substeps, ik_iters,
                         solve_iters, with_ee)
        if source != SOURCE:      # another copy may lack the newer fields
            names = {f[0] for f in model_fields(_source_text(source))}
            v = {k: x for k, x in v.items() if k in names}
        self.source = source
        self.blob = model_bytes(v, source)
        self._on = {}

    def _model_on(self, device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.frombuffer(bytearray(self.blob), dtype=torch.uint8
                                 ).to(device)
            self._on[device] = t
        return t

    def launch(self, which: str, device, B: int, *args):
        """Enqueue one kernel on the current stream; raise if refused."""
        lib = library(self.source)
        m = self._model_on(device).data_ptr()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):     # the runtime launches on it
            code = self._launch(lib, which, m, stream, B, args)
        if code != 0:
            msg = lib.fs_error_string(code).decode()
            raise RuntimeError(f"fused_step {which} kernel launch failed: "
                               f"{msg} ({code})")

    @staticmethod
    def _launch(lib, which, m, stream, B, args) -> int:
        if which == "rollout":
            X, act, Y, ags, H = args
            return lib.fs_rollout(m, X.data_ptr(), act.data_ptr(),
                                  Y.data_ptr(), ags.data_ptr(), H, B, stream)
        if which == "step":
            X, act, Y, C = args
            return lib.fs_step(m, X.data_ptr(), act.data_ptr(), Y.data_ptr(),
                               None if C is None else C.data_ptr(), B, stream)
        X, ctrl, grip, Y = args
        return lib.fs_sim(m, X.data_ptr(), ctrl.data_ptr(), grip.data_ptr(),
                          Y.data_ptr(), B, stream)

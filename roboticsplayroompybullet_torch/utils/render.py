"""Camera observations: a batched primary-ray caster (port of
roboticsplayroompybullet_tpu/utils/render.py).

The reference renders 200x200 RGB camera images with Bullet's renderer
(reference environments.py:25 `pixels = 200`, 841-843 `getCameraImage` when
`record_images`; global camera environments.py:28-30: target [0, 0.25, 0],
distance 1.3, yaw -30, pitch -30, roll 0, up axis z, FOV 50, aspect 1;
wrist camera environments.py:33-49). The scene is analytic primitives
(boxes, spheres, a plane), so the renderer casts one primary ray a pixel
and shades the nearest hit (Lambert), on the state's device, for a batch
of envs at once. It is plain PyTorch, as the JAX package's is plain XLA.

Where JAX tests one primitive at a time against a running nearest hit
(strict `t < best`), this file tests each kind of primitive as one stacked
(rays x primitives) batch and takes its first minimum: plane, boxes
(static, articulated k by k, blocks), bone spheres, in JAX's order, so
the same primitive wins every tie. The envs go through in chunks of at
most PAIRS ray-primitive pairs.

Colors follow complex_scene's visual palette (reference scenes.py:52-56
blue/red blocks, 93-114 wood statics, 133 door, 241-248 button, 406-413
dial).
"""
from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..envs import physics
from ..envs.config import EnvConfig
from ..envs.state import EnvState
from ..models.arms import ArmConfig
from ..models.kinetree import KineTree
from ..models.playroom import Scene
from ..ops import fused_step as fs
from ..ops import spatial as sp

# reference camera constants (environments.py:28-30)
CAM_TARGET = (0.0, 0.25, 0.0)
CAM_DISTANCE = 1.3
CAM_YAW = -30.0
CAM_PITCH = -30.0
CAM_FOV = 50.0
PIXELS = 200

_BIG = 1e9
# ray-primitive pairs tested at once: a (pairs, 3) float32 temporary is
# 96 MiB and the slab test holds about six, so a batch of 200x200 frames
# takes under 1 GiB whatever B
PAIRS = 1 << 23


class Camera(NamedTuple):
    eye: torch.Tensor      # (3,) or (B, 3)
    right: torch.Tensor    # (3,) or (B, 3)
    up: torch.Tensor       # (3,) or (B, 3)
    forward: torch.Tensor  # (3,) or (B, 3)
    tan_half_fov: float


def _norm(x):
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def camera_from_yaw_pitch(target=CAM_TARGET, distance=CAM_DISTANCE,
                          yaw=CAM_YAW, pitch=CAM_PITCH, fov=CAM_FOV,
                          device=None) -> Camera:
    """Bullet-style orbit camera, up axis z (computeViewMatrixFromYawPitchRoll
    semantics: yaw about +z, pitch tilts toward/away, eye orbits target),
    on `device` (the card unless the caller names another). The basis is
    computed in float32 on the CPU and copied, so every device gets the
    same bits."""
    f32 = torch.float32
    t = torch.tensor(target, dtype=f32)
    yr, pr = math.radians(yaw), math.radians(pitch)
    # eye offset in world: yaw=0 looks along +y; pitch<0 looks down
    cp, sp_ = math.cos(pr), math.sin(pr)
    cy, sy = math.cos(yr), math.sin(yr)
    back = torch.tensor([sy * cp, -cy * cp, -sp_], dtype=f32)  # target->eye
    eye = t + distance * back
    fwd = -back
    world_up = torch.tensor([0.0, 0.0, 1.0], dtype=f32)
    right = torch.linalg.cross(fwd, world_up, dim=-1)
    right = right / _norm(right)
    up = torch.linalg.cross(right, fwd, dim=-1)
    dev = torch.device("cuda" if device is None else device)
    return Camera(eye.to(dev), right.to(dev), up.to(dev), fwd.to(dev),
                  math.tan(math.radians(fov) / 2))


def camera_from_pose(eye, forward, up_hint=(0.0, 0.0, 1.0),
                     fov=CAM_FOV) -> Camera:
    """Free camera (wrist camera path, environments.py:33-49); eye and
    forward (3,) or (B, 3) tensors, on their device."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    fwd = torch.as_tensor(forward, dtype=torch.float32, device=eye.device)
    fwd = fwd / _norm(fwd)
    hint = torch.as_tensor(up_hint, dtype=torch.float32, device=eye.device)
    fwd, hint = torch.broadcast_tensors(fwd, hint)
    right = torch.linalg.cross(fwd, hint, dim=-1)
    right = right / torch.clamp_min(_norm(right), 1e-6)
    up = torch.linalg.cross(right, fwd, dim=-1)
    return Camera(eye, right, up, fwd, math.tan(math.radians(fov) / 2))


# ---------------------------------------------------------------------------
# ray-primitive intersections, batched over leading axes: o, d (..., 3); a
# box's center (..., 3), quat (..., 4) and half extents (..., 3) broadcast
# against them
# ---------------------------------------------------------------------------

def _ray_plane_z(o, d, z):
    """t of intersection with the plane z = z (_BIG if parallel/behind)."""
    dz = d[..., 2]
    t = (z - o[..., 2]) / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    return torch.where((t > 1e-4) & (torch.abs(dz) > 1e-9), t, _BIG)


def _slab(o, d, center, quat, half):
    """The oriented-box slab test: (t (_BIG on a miss), tmin, t_near, dl)."""
    ol = sp.quat_rotate_inverse(quat, o - center)
    dl = sp.quat_rotate_inverse(quat, d)
    dl_safe = torch.where(torch.abs(dl) < 1e-9, 1e-9, dl)
    t1 = (-half - ol) / dl_safe
    t2 = (half - ol) / dl_safe
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = tmin.amax(-1)
    t_far = tmax.amin(-1)
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t = torch.where(t_near > 1e-4, t_near, t_far)
    return torch.where(hit, t, _BIG), tmin, t_near, dl


def _ray_box(o, d, center, quat, half):
    """Oriented-box slab test → (t, normal_world), t = _BIG on a miss."""
    t, tmin, t_near, dl = _slab(o, d, center, quat, half)
    # face normal: the first axis of t_near, against the local direction
    ax = torch.argmax((tmin == t_near[..., None]).to(torch.float32), dim=-1)
    one_hot = torch.nn.functional.one_hot(ax, 3).to(o.dtype)
    n_local = -one_hot * torch.sign(torch.gather(dl, -1, ax[..., None]))
    return t, sp.quat_rotate(quat, n_local)


def _sphere_t(o, d, center, radius):
    """t of a ray's first hit on a sphere (_BIG on a miss)."""
    oc = o - center
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = -b - sq
    return torch.where((disc > 0) & (t > 1e-4), t, _BIG)


def _ray_sphere(o, d, center, radius):
    """(t, unit normal at the hit)."""
    t = _sphere_t(o, d, center, radius)
    n = o + t[..., None] * d - center
    return t, n / torch.clamp_min(_norm(n), 1e-9)


# ---------------------------------------------------------------------------
# scene assembly + shading
# ---------------------------------------------------------------------------

_WOOD = (0.72, 0.58, 0.42)
_BLOCK_COLORS = ((0.0, 0.3, 1.0), (1.0, 0.2, 0.2))   # blue, red
_ART_COLORS = (
    (0.85, 0.75, 0.55),   # drawer
    (0.55, 0.35, 0.2),    # door
    (1.0, 1.0, 1.0),      # button
    (0.2, 0.8, 0.3),      # dial
)
_PLANE_COLOR = (0.45, 0.45, 0.48)
_ARM_COLOR = (0.85, 0.85, 0.88)
_LIGHT = (0.4, -0.35, 0.85)
_SKY = (0.65, 0.75, 0.9)
_BONE = 3                 # spheres per link
_BONE_RADIUS = 0.045


@functools.lru_cache(maxsize=16)
def _default_view(pixels: int, device: torch.device):
    """(camera, rays (1, R, 3)) of the reference's global camera, computed
    on the CPU and copied once to `device`."""
    cam = camera_from_yaw_pitch(device="cpu")
    d = _rays(_batched(cam), pixels)
    return (Camera(*(f.to(device) for f in cam[:4]), cam.tan_half_fov),
            d.to(device))


def _batched(cam: Camera) -> Camera:
    return Camera(*(f.reshape(-1, 3) for f in cam[:4]), cam.tan_half_fov)


def _rays(cam: Camera, pixels: int):
    """(Bc, R, 3) unit ray directions of a camera with (Bc, 3) fields,
    row-major from the image's top left."""
    dev = cam.eye.device
    i = (torch.arange(pixels, dtype=torch.float32) + 0.5) / pixels * 2.0 - 1.0
    # JAX's meshgrid(ix, -iy): 'xy' indexing, rows run down the image
    px, py = torch.meshgrid(i, -i, indexing="xy")
    px, py = px.to(dev)[None, ..., None], py.to(dev)[None, ..., None]
    f, r, u = (x[:, None, None] for x in (cam.forward, cam.right, cam.up))
    d = f + cam.tan_half_fov * (px * r + py * u)
    d = d / _norm(d)
    return d.reshape(d.shape[0], -1, 3)


def _boxes(cfg: EnvConfig, scene: Scene, state: EnvState):
    """The opaque boxes in JAX's order (static, articulated k by k,
    blocks): centers (B, N, 3), quats (B, N, 4), halves (N, 3), colors
    (N, 3). Padded articulated slots (zero half) are left out: JAX's
    disabled box never takes the nearest hit."""
    B, dev = state.q.shape[0], state.q.device
    ident = fs.const_on(np.array([0.0, 0.0, 0.0, 1.0]), dev)
    centers, quats, halves, colors = [], [], [], []
    for i in range(scene.static_pos.shape[0]):
        centers.append(fs.const_on(scene.static_pos[i], dev).expand(B, 3))
        quats.append(ident.expand(B, 4))
        halves.append(scene.static_half[i])
        colors.append(_WOOD)
    if scene.has_articulated:
        for k in range(4):
            bpos, bquat = physics.art_box_pose(scene, k, state.art_q)
            for b in range(scene.art_boxes_pos.shape[1]):
                half = scene.art_boxes_half[k, b]
                if float(np.sum(half)) <= 0.0:
                    continue
                centers.append(bpos + sp.quat_rotate(bquat, fs.const_on(
                    scene.art_boxes_pos[k, b], dev)))
                quats.append(bquat)
                halves.append(half)
                colors.append(_ART_COLORS[k])
    for ob in range(cfg.num_objects):
        centers.append(state.obj_pos[:, ob])
        quats.append(state.obj_quat[:, ob])
        halves.append(scene.block_half)
        colors.append(_BLOCK_COLORS[ob % 2])
    if not centers:
        return None
    return (torch.stack(centers, 1), torch.stack(quats, 1),
            fs.const_on(np.stack(halves), dev),
            fs.const_on(np.array(colors), dev))


def _bones(tree: KineTree, state: EnvState):
    """(B, 3 n_dof, 3) centers of the arm's bone spheres: three along each
    link, from its parent's origin to its own."""
    pos, _ = fs.lane_fk_links(tree, state.q.T)
    pos = [p.T for p in pos]
    base = fs.const_on(tree.base_pos, state.q.device)
    centers = []
    for i in range(tree.n_dof):
        p_idx = tree.parent[i]
        a = pos[p_idx] if p_idx >= 0 else base.expand_as(pos[i])
        b = pos[i]
        for s in range(_BONE):
            centers.append(a + (s + 1) / _BONE * (b - a))
    return torch.stack(centers, 1)


def _env_rows(x, lo, hi):
    """Rows lo:hi of a per-env tensor; a shared one (leading 1) as it is."""
    return x if x.shape[0] == 1 else x[lo:hi]


def _pick(x, idx):
    """x (b, N, k) at each ray's index idx (b, R) → (b, R, k)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _shade(o, d, plane_z, boxes, bones):
    """The opaque image (b, R, 3) and each ray's nearest t (b, R)."""
    best_t = _ray_plane_z(o, d, plane_z)
    best_n = fs.const_on(np.array([0.0, 0.0, 1.0]), d.device).expand_as(d)
    best_c = fs.const_on(np.array(_PLANE_COLOR), d.device).expand_as(d)

    def consider(t, n, c):
        nonlocal best_t, best_n, best_c
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_n = torch.where(closer[..., None], n, best_n)
        best_c = torch.where(closer[..., None], c, best_c)

    oo, dd = o[:, :, None], d[:, :, None]
    if boxes is not None:
        centers, quats, halves, colors = boxes
        t = _slab(oo, dd, centers[:, None], quats[:, None], halves)[0]
        t, idx = t.min(-1)                  # the first of equal minima
        _, n = _ray_box(o, d, _pick(centers, idx), _pick(quats, idx),
                        halves[idx])
        consider(t, n, colors[idx])
    t = _sphere_t(oo, dd, bones[:, None], _BONE_RADIUS)
    t, idx = t.min(-1)
    _, n = _ray_sphere(o, d, _pick(bones, idx), _BONE_RADIUS)
    consider(t, n, fs.const_on(np.array(_ARM_COLOR), d.device))

    light = fs.const_on(np.array(_LIGHT), d.device)
    light = light / _norm(light)
    lam = torch.clamp((best_n * light).sum(-1), 0.0, 1.0)
    shade = 0.35 + 0.65 * lam
    sky = fs.const_on(np.array(_SKY), d.device)
    img = torch.where((best_t < _BIG * 0.5)[..., None],
                      best_c * shade[..., None], sky)
    return img, best_t


def _blend(img, t, best_t, alpha, color):
    """Translucent overlays in order: t (b, R, K) of each, alpha (b', K),
    color (b', K, 3); each shows where it is in front of the opaque hit."""
    for k in range(t.shape[-1]):
        a = torch.where(t[..., k] < best_t, alpha[:, k, None], 0.0)[..., None]
        img = img * (1.0 - a) + color[:, k, None] * a
    return img


def _ghost_inputs(x, n_dims: int, dev):
    """A ghost array as a float32 tensor on dev with a leading env axis
    ((K, ...) shared by every env becomes (1, K, ...))."""
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return x[None] if x.dim() == n_dims else x


def render_state(cfg: EnvConfig, tree: KineTree, arm: ArmConfig,
                 scene: Scene, state: EnvState,
                 camera: Optional[Camera] = None,
                 pixels: int = PIXELS,
                 ghosts: Optional[tuple] = None,
                 ghost_boxes: Optional[tuple] = None) -> torch.Tensor:
    """(B, pixels, pixels, 3) float32 RGB in [0, 1] of the B envs of
    `state`, on the state's device.

    camera: the reference's global camera by default; a Camera with
    (B, 3) fields gives each env its own (wrist_camera).

    ghosts: optional (centers (K,3), radii (K,), colors (K,3), alphas (K,))
    — translucent sub-goal marker spheres blended over the frame, the
    analogue of the reference's collision-masked rgba-0.3 ghost bodies
    (environments.py:606-703; scenes.py ghostly branches). alpha 0
    disables a slot. Each array may carry a leading (B,) env axis.

    ghost_boxes: optional (centers (K,3), quats (K,4), halves (K,3),
    colors (K,3), alphas (K,)) — translucent ORIENTED-BOX ghosts for block
    sub-goals and the ghost door/drawer/button/dial posed at sub-goal
    joint values (environments.py:684-717). Zero half disables.

    When cfg.show_goal (non-play), desired-goal spheres are rendered
    straight from state.goal — they track every reset_goal_pos like the
    reference's constraint-pinned goal bodies (environments.py:433-452,
    492-516)."""
    dev = state.q.device
    B = state.q.shape[0]
    if camera is None:
        cam, d = _default_view(pixels, dev)
    else:
        cam = _batched(camera)
        d = _rays(cam, pixels)
    o = cam.eye.reshape(-1, 1, 3)
    boxes = _boxes(cfg, scene, state)
    bones = _bones(tree, state)
    goals = None
    if cfg.show_goal and not cfg.play and cfg.num_goals:
        goals = state.goal[:, :3 * cfg.num_goals].reshape(B, -1, 3)
    if ghosts is not None:
        ghosts = tuple(_ghost_inputs(x, n, dev)
                       for x, n in zip(ghosts, (2, 1, 2, 1)))
    if ghost_boxes is not None:
        ghost_boxes = tuple(_ghost_inputs(x, n, dev)
                            for x, n in zip(ghost_boxes, (2, 2, 2, 2, 1)))
    stacks = [bones, goals] + [group[0] for group in (boxes, ghosts,
                                                      ghost_boxes)
                               if group is not None]
    widest = max(x.shape[1] for x in stacks if x is not None)
    step = max(1, PAIRS // (d.shape[1] * widest))

    frames = []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        rows = functools.partial(_env_rows, lo=lo, hi=hi)
        oc, dc = rows(o), rows(d)
        bx = None if boxes is None else (rows(boxes[0]), rows(boxes[1]),
                                         boxes[2], boxes[3])
        img, best_t = _shade(oc, dc, float(scene.plane_z), bx,
                             rows(bones))
        oo, dd = oc[:, :, None], dc[:, :, None]
        if goals is not None:
            # desired-goal markers (environments.py:433-452)
            g = rows(goals)
            t = _sphere_t(oo, dd, g[:, None], 0.03)
            n = g.shape[1]
            img = _blend(img, t, best_t, torch.full((1, n), 0.45,
                                                    device=dev),
                         fs.const_on(np.array([_BLOCK_COLORS[i % 2]
                                               for i in range(n)]),
                                     dev)[None])
        if ghosts is not None:
            g_pos, g_rad, g_col, g_alpha = (rows(x) for x in ghosts)
            t = _sphere_t(oo, dd, g_pos[:, None], g_rad[:, None])
            img = _blend(img, t, best_t, g_alpha, g_col)
        if ghost_boxes is not None:
            b_pos, b_quat, b_half, b_col, b_alpha = (rows(x)
                                                     for x in ghost_boxes)
            t = _slab(oo, dd, b_pos[:, None], b_quat[:, None],
                      b_half[:, None])[0]
            t = torch.where((b_half.sum(-1) > 0)[:, None], t, _BIG)
            img = _blend(img, t, best_t, b_alpha, b_col)
        frames.append(img.expand(hi - lo, -1, 3))
    return torch.cat(frames).reshape(B, pixels, pixels, 3)


def wrist_camera(tree: KineTree, arm: ArmConfig, state: EnvState) -> Camera:
    """Each env's wrist camera: the ee frame pitched −π/2, forward = its
    rotated x-axis (gripper_camera, environments.py:33-49); (B, 3) fields."""
    from ..envs.obs import ee_state
    pos, quat, _, _ = ee_state(tree, arm, state.q, state.qd)
    pitch = fs.const_on(np.array([0.0, -np.pi / 2, 0.0]), pos.device)
    q2 = sp.quat_from_euler(sp.quat_to_euler(quat) + pitch)
    x = fs.const_on(np.array([1.0, 0.0, 0.0]), pos.device)
    z = fs.const_on(np.array([0.0, 0.0, 1.0]), pos.device)
    return camera_from_pose(pos, sp.quat_rotate(q2, x),
                            sp.quat_rotate(q2, z))


def write_png(path: str, img) -> None:
    """Minimal dependency-free PNG writer (8-bit RGB).

    The headless analogue of the reference's live GUI window
    (environments.py:220-224 p.connect(p.GUI)): render('human') streams
    frames to a file a viewer can watch. Pure stdlib (zlib/struct)."""
    import struct
    import zlib

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)

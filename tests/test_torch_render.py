"""PyTorch port: the raycaster (utils/render.py), the sub-goal ghosts of
PlayEnv and utils/metrics.py, held to the JAX package's outputs (fixture
render_camera, tools/gen_port_fixtures.py) on the CPU.

Frames follow the pixel rule (tests/_torch_port.py::pixel_rule): per
channel |Δ| ≤ 1e-4 on at least 99.5 % of the pixels, every value in
[0, 1]. Ghost boxes are held within 1e-5; the ghost arm's spheres, the
fixed points of two IKs (JAX's float32 kinematics.ik_dls, the port's
float64 lane IK), within 1e-3 m."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch import utils as U
from roboticsplayroompybullet_torch.envs import core, wrapper
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.utils import render as rnd

import _torch_port as tp

torch.set_num_threads(1)
PX = 48
GHOST = ("pos", "rad", "col", "alp")
GHOST_BOX = ("pos", "quat", "half", "col", "alp")


@pytest.fixture(scope="module")
def z():
    return tp.load("render_camera")


def _state(z, prefix):
    """The B=1 state stored under `prefix`_<field>, on the CPU."""
    return interop.state_from_numpy(
        {f: z[f"{prefix}_{f}"] for f in interop.FIELDS}, device="cpu")


def _model(env_id, **cfg_kw):
    return core.build_model(dataclasses.replace(CATALOG[env_id], **cfg_kw))


def _ghosts(z, prefix):
    return (tuple(z[f"{prefix}_g_{n}"] for n in GHOST),
            tuple(z[f"{prefix}_gb_{n}"] for n in GHOST_BOX))


# case → (env id, cfg changes, state prefix, render_state keywords)
CASES = {
    "pick_plain": ("pandaPick-v0", {}, "pick", lambda z: {"pixels": PX}),
    "pick_ghost": ("pandaPick-v0", {}, "pick", lambda z: {
        "pixels": PX, "ghosts": tuple(z[f"pick_ghost_{n}"] for n in GHOST)}),
    "pick_ghost0": ("pandaPick-v0", {}, "pick", lambda z: {
        "pixels": PX, "ghosts": tuple(z[f"pick_ghost_{n}"] for n in GHOST[:3])
        + (np.zeros(1, np.float32),)}),
    "pick_wrist": ("pandaPick-v0", {}, "pick", "wrist"),
    "reach_goal_on": ("UR5Reach-v0", {}, "reach", lambda z: {"pixels": PX}),
    "reach_goal_off": ("UR5Reach-v0", {"show_goal": False}, "reach",
                       lambda z: {"pixels": PX}),
    "flag_plain": ("UR5PlayAbsRPY1Obj-v0", {}, "flag", lambda z: {}),
    "flag_ghost": ("UR5PlayAbsRPY1Obj-v0", {}, "flag", lambda z: dict(zip(
        ("ghosts", "ghost_boxes"), _ghosts(z, "flag")))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_state_matches_jax(z, case):
    env_id, cfg_kw, prefix, kw = CASES[case]
    m = _model(env_id, **cfg_kw)
    st = _state(z, prefix)
    if kw == "wrist":
        kw = {"pixels": PX, "camera": rnd.wrist_camera(m.tree, m.arm, st)}
    else:
        kw = kw(z)
    img = rnd.render_state(*m, st, **kw)
    assert img.dtype == torch.float32 and img.shape[0] == 1
    ok, outliers = tp.pixel_rule(img[0].numpy(), z[case])
    print(f"{case}: {outliers} channel values off by more than "
          f"{tp.PIXEL_TOL}")
    assert ok, (case, outliers)
    assert img.std() > 0.02           # not a flat image


def test_zero_alpha_ghost_is_a_no_op(z):
    """A ghost of alpha 0 leaves every pixel as it was; one of alpha 0.5
    changes some (tests/test_utils.py's case)."""
    m = _model("pandaPick-v0")
    st = _state(z, "pick")
    base = rnd.render_state(*m, st, pixels=PX)
    ghosts = tuple(z[f"pick_ghost_{n}"] for n in GHOST)
    img = rnd.render_state(*m, st, pixels=PX, ghosts=ghosts)
    assert float((img - base).abs().max()) > 0.05
    img0 = rnd.render_state(*m, st, pixels=PX,
                            ghosts=ghosts[:3] + (np.zeros(1, np.float32),))
    assert torch.equal(img0, base)


def test_a_batch_renders_each_env_as_alone(z, monkeypatch):
    """Three flagship envs in one call, in chunks of one env (PAIRS cut),
    with per-env wrist cameras and shared ghosts: each frame as that env
    rendered alone."""
    m = _model("UR5PlayAbsRPY1Obj-v0")
    st = _state(z, "flag")
    rs = np.random.RandomState(3)
    n = 3
    st = st.__class__(**{f: torch.cat([getattr(st, f)] * n)
                         for f in dataclasses.asdict(st)})
    st = st.replace(q=st.q + torch.as_tensor(rs.uniform(
        -0.3, 0.3, st.q.shape), dtype=torch.float32), obj_pos=st.obj_pos
        + torch.as_tensor(rs.uniform(-0.05, 0.05, st.obj_pos.shape),
                          dtype=torch.float32))
    g, gb = _ghosts(z, "flag")
    alone = []
    for i in range(n):
        one = st.__class__(**{f: getattr(st, f)[i:i + 1]
                              for f in dataclasses.asdict(st)})
        for cam in (None, rnd.wrist_camera(m.tree, m.arm, one)):
            alone.append(rnd.render_state(*m, one, camera=cam, pixels=PX,
                                          ghosts=g, ghost_boxes=gb)[0])
    monkeypatch.setattr(rnd, "PAIRS", 1)
    for j, cam in enumerate((None, rnd.wrist_camera(m.tree, m.arm, st))):
        got = rnd.render_state(*m, st, camera=cam, pixels=PX, ghosts=g,
                               ghost_boxes=gb)
        assert got.shape == (n, PX, PX, 3)
        for i in range(n):
            ok, outliers = tp.pixel_rule(got[i].numpy(),
                                         alone[2 * i + j].numpy())
            assert ok, (i, j, outliers)
    assert float((alone[0] - alone[2]).abs().max()) > 0.05


# case → (env id, sub-goal kind, the sub-goal's fixture key)
GHOST_CASES = {"flag": ("UR5PlayAbsRPY1Obj-v0", "full_positional_state",
                        "flag_sub_goal"),
               "pplay_unit": ("pandaPlayAbsRPY1Obj-v0", "achieved_goal",
                              "pplay_unit_ag"),
               "pplay_zero": ("pandaPlayAbsRPY1Obj-v0", "achieved_goal",
                              "pplay_zero_ag"),
               "pick_ag": ("pandaPick-v0", "achieved_goal", "pick_ag"),
               "reach_cag": ("UR5Reach-v0", "controllable_achieved_goal",
                             "reach_cag")}


@pytest.mark.parametrize("case", sorted(GHOST_CASES))
def test_sub_goal_ghosts_match_jax(z, case):
    """PlayEnv._sub_goal_ghosts of a stored sub-goal, against JAX's: the
    non-play ghost half 0.03, the quaternion normalised (or the identity
    below 1e-6), the dial's ×2.2, the articulated padding left empty, the
    alphas 0.35 / 0.4 / 0.5; delete_sub_goal empties every slot."""
    env_id, kind, key = GHOST_CASES[case]
    env = wrapper.make(env_id, device="cpu")
    env.visualise_sub_goal(z[key], kind)
    (pos, rad, col, alp), boxes = env._sub_goal_ghosts()
    want_s, want_b = _ghosts(z, case)
    np.testing.assert_allclose(pos, want_s[0], rtol=0, atol=1e-3)
    for got, want in zip((rad, col, alp), want_s[1:]):
        np.testing.assert_array_equal(got, want)
    for name, got, want in zip(GHOST_BOX, boxes, want_b):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert alp.max() > 0 or boxes[4].max() > 0
    env.delete_sub_goal()
    (_, _, _, alp), boxes = env._sub_goal_ghosts()
    assert alp.max() == 0 and boxes[4].max() == 0


@pytest.mark.parametrize("name", ["u8", "f32"])
def test_write_png_bytes_match_jax(z, tmp_path, name):
    path = str(tmp_path / "frame.png")
    rnd.write_png(path, z[f"png_{name}_img"])
    with open(path, "rb") as f:
        assert f.read() == z[f"png_{name}"].tobytes()


@pytest.mark.parametrize("tag,env_id", [("bits_flag", "UR5PlayAbsRPY1Obj-v0"),
                                        ("bits_pplay", "pandaPlay-v0")])
def test_play_element_bits_match_jax(z, tag, env_id):
    """Bit for bit, thresholds hit exactly and missed by one float32 step
    among the rows."""
    bits = U.play_element_bits(CATALOG[env_id], torch.as_tensor(z[f"{tag}_ag"]),
                               torch.as_tensor(z[f"{tag}_g"]))
    want = {k[len(tag) + 1:]: v for k, v in z.items()
            if k.startswith(tag + "_") and k[len(tag) + 1:] not in ("ag", "g")}
    assert set(bits) == set(want)
    for k, v in bits.items():
        assert v.dtype == torch.bool
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # rows 2i / 2i+1: threshold i hit exactly / missed by one float32
    # step; rows 10 / 11: a block turned 0.78 / 0.79 rad (pi/4 = 0.785)
    for i, k in enumerate(("block0_pos_ok", "drawer_ok", "door_ok",
                           "button_ok", "dial_ok", "block0_rot_ok")):
        assert want[k][2 * i] and not want[k][2 * i + 1], k


def test_jsonl_sink_takes_tensors(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with U.JsonlSink(p) as sink:
        sink.log(0, reward=torch.tensor(-1.0), ee_err=0.02)
        sink.log(1, {"bits": torch.tensor([1, 0, 1])},
                 ok=torch.tensor(True), arr=np.float32(0.5))
    recs = [json.loads(line) for line in open(p)]
    assert recs[0]["reward"] == -1.0 and recs[0]["step"] == 0
    assert recs[0]["ee_err"] == 0.02
    assert recs[1]["bits"] == [1, 0, 1] and recs[1]["ok"] is True
    assert recs[1]["arr"] == 0.5


def test_utils_exports_what_jax_does():
    assert set(U.__all__) == {"save_pytree", "load_pytree", "JsonlSink",
                              "play_element_bits", "timeit", "trace"}
    assert all(callable(getattr(U, n)) for n in U.__all__)

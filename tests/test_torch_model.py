"""PyTorch port: model constants, packed layout and the Model struct the
CUDA kernel reads, against the JAX package (numpy comparisons, no jit)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roboticsplayroompybullet_tpu.envs import core as jcore
from roboticsplayroompybullet_tpu.envs.config import CATALOG as JCATALOG
from roboticsplayroompybullet_tpu.envs.state import EnvState as JState
from roboticsplayroompybullet_tpu.models import playroom as jplay
from roboticsplayroompybullet_tpu.ops import fused_step as jfs

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.models import playroom
from roboticsplayroompybullet_torch.ops import cuda_build
from roboticsplayroompybullet_torch.ops import fused_step as fs

import _torch_port as tp

torch.set_num_threads(1)
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"


def _assert_same(a, b, where):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
    else:
        assert a == b, where


def test_catalog_ids_match():
    assert sorted(CATALOG) == sorted(JCATALOG)
    assert len(CATALOG) == 19


@pytest.mark.parametrize("env_id", sorted(JCATALOG))
def test_build_model_constants_match(env_id):
    """Every constant of the port's build_model equals the JAX one."""
    ours, ref = core.build_model(CATALOG[env_id]), jcore.build_model(
        JCATALOG[env_id])
    for name, a, b in zip(("cfg", "tree", "arm", "scene"), ours, ref):
        _assert_same(a, b, f"{env_id}.{name}")
    # every derived config property too
    for p in ("dt", "num_goals", "scene_kind", "n_arm", "action_dim",
              "action_high", "goal_dim", "obs_dim", "ag_dim"):
        assert getattr(ours.cfg, p) == getattr(ref.cfg, p), p


@pytest.mark.parametrize("env_id", sorted(JCATALOG))
def test_kernel_model_struct_packs(env_id):
    """The CUDA kernel's Model struct gets a value for every field, within
    its compile-time maxima, for every catalog env."""
    m = core.build_model(CATALOG[env_id])
    v = cuda_build.model_values(*m, n_substeps=12, ik_iters=24,
                                solve_iters=8, with_ee=True)
    blob = cuda_build.model_bytes(v)
    assert len(blob) > 0
    assert v["nf"] == fs._field_rows(m.cfg, m.tree)[1]
    assert v["ag_dim"] == fs.ag_layout(m.cfg, m.tree, True)[1]


def test_pack_state_matches_jax_and_round_trips():
    m = core.build_model(CATALOG[FLAGSHIP])
    d = tp.load(f"reset_{tp.key(FLAGSHIP)}")
    st = interop.state_from_numpy(d, device="cpu")
    X = fs.pack_state(m.cfg, m.tree, st)
    jm = jcore.build_model(JCATALOG[FLAGSHIP])
    jX = jfs.pack_state(jm.cfg, jm.tree,
                        JState(**{k: jnp.asarray(v) for k, v in d.items()}))
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    back = fs.unpack_state(m.cfg, m.tree, X * 2.0, st)
    for f in fs.STATE_KEYS:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      2.0 * d[f], err_msg=f)
    np.testing.assert_array_equal(back.goal.numpy(), d["goal"])
    out = interop.state_to_numpy(st)
    for f, a in d.items():
        np.testing.assert_array_equal(out[f], a, err_msg=f)
        assert out[f].dtype == a.dtype, f


def test_pack_state_without_objects_round_trips():
    m = core.build_model(CATALOG["UR5Reach-v0"])
    rs = np.random.RandomState(0)
    B, n = 5, m.tree.n_dof
    d = {f: np.zeros(s, np.float32) for f, s in [
        ("ctrl_q", (B, 6)), ("grip", (B,)), ("obj_pos", (B, 1, 3)),
        ("obj_quat", (B, 1, 4)), ("obj_vel", (B, 1, 3)),
        ("obj_angvel", (B, 1, 3)), ("goal", (B, 3)), ("prev_obs", (B, 7)),
        ("prev_ag", (B, 3))]}
    d.update(q=rs.randn(B, n).astype(np.float32),
             qd=rs.randn(B, n).astype(np.float32),
             art_q=rs.randn(B, 4).astype(np.float32),
             art_qd=rs.randn(B, 4).astype(np.float32),
             has_prev=np.zeros(B, bool), rng=np.zeros((B, 2), np.uint32),
             t=np.zeros(B, np.int32))
    st = interop.state_from_numpy(d, device="cpu")
    X = fs.pack_state(m.cfg, m.tree, st)
    assert X.shape == (2 * n + 8, B)
    back = fs.unpack_state(m.cfg, m.tree, X, st)
    for f in ("q", "qd", "art_q", "art_qd", "obj_pos"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), d[f])


def test_dial_to_0_1_range_matches_on_negative_inputs():
    """Python floor-mod (precedence bug kept) on both signs, in the model
    helper and in the rollout's achieved-goal row."""
    x = np.array([-7.3, -2.0, -1.5, -1e-7, 0.0, 0.3, 1.999, 2.0, 5.25],
                 np.float32)
    ref = np.asarray(jplay.dial_to_0_1_range(jnp.asarray(x)))
    ours = playroom.dial_to_0_1_range(torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)
    m = core.build_model(CATALOG[FLAGSHIP])
    _, NF = fs._field_rows(m.cfg, m.tree)
    X = torch.zeros(NF, x.size)
    X[NF - 5] = torch.tensor(x)                       # art_q[3], the dial
    ag = fs.make_lane_ag(m.cfg, m.tree, m.arm)(X)
    np.testing.assert_allclose(ag[-1].numpy(), ref, rtol=0, atol=1e-7)


def _plain_bundles(m):
    """The plain twin's contact bundles of one env at rest (B=1)."""
    _, NF = fs._field_rows(m.cfg, m.tree)
    X = torch.zeros(NF, 1)
    quat0 = 2 * m.tree.n_dof + 3 * m.cfg.num_objects
    X[quat0 + 3:quat0 + 4 * m.cfg.num_objects:4] = 1.0   # unit quaternions
    st = fs._lanes_from_block(m.cfg, m.tree, X)
    kin = fs.lane_fk_vel(m.tree, st["q"], st["qd"])
    pads = fs.lane_pad_kinematics(m.tree, m.arm, kin)
    return fs.gather_bundles(m.cfg, m.tree, m.arm, m.scene, st, kin,
                             st["qd"], *pads)[0]


@pytest.mark.parametrize("env_id", sorted(JCATALOG))
def test_kernel_row_table_matches_plain_bundles(env_id):
    """The kernel's static contact-row table (Model.n_rows, row_code) has
    the plain twin's rows, bundle by bundle, and fits the lanes' slots."""
    m = core.build_model(CATALOG[env_id])
    v = cuda_build.model_values(*m, n_substeps=12, ik_iters=24,
                                solve_iters=8, with_ee=False)
    rows = cuda_build.row_table(m.cfg, m.scene, v["pad_slot"])
    assert [cuda_build.row_code(r) for r in rows] == v["row_code"]
    i = 0
    for bd in _plain_bundles(m):
        for r in rows[i:i + bd.depth.shape[0]]:
            assert (r["a"], r["b"], r["k"], r["g"], r["pj"]) == (
                bd.a, bd.b, bd.k, bd.g, bd.pj), (i, r, bd[4:])
            assert (r["vk"] >= 0) == (bd.vkin is not None), (i, r)
        i += bd.depth.shape[0]
    assert v["n_rows"] == i == len(rows)
    assert v["n_rows"] <= cuda_build.row_capacity()


@pytest.mark.parametrize("env_id", sorted(JCATALOG))
def test_kernel_launch_shared_memory_fits_a_block(env_id):
    """Model (its table filled for this env) plus FS_ENVS EnvSh per block
    stay within the 232,448 bytes of shared memory a Hopper block may use."""
    m = core.build_model(CATALOG[env_id])
    v = cuda_build.model_values(*m, n_substeps=12, ik_iters=24,
                                solve_iters=8, with_ee=True)
    smem = cuda_build.launch_smem_bytes()
    assert -(-len(cuda_build.model_bytes(v)) // 16) * 16 < smem <= 232448

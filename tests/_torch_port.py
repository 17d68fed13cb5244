"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

The JAX outputs the port is held to come from committed fixtures
(tests/torch_fixtures/*.npz, written by tools/gen_port_fixtures.py), so no
port test compiles the JAX lane twin. Each fixture records the sha256 of
the JAX sources it depends on; `load` refuses a stale one.
"""
import hashlib
import json
import os

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")


def load(name: str) -> dict:
    """Fixture `name` as a dict of numpy arrays, after checking that the
    JAX sources it was made from are unchanged."""
    with np.load(os.path.join(FIXTURES, name + ".npz")) as z:
        d = {k: z[k] for k in z.files}
    for rel, digest in json.loads(str(d.pop("sources_json"))).items():
        with open(os.path.join(ROOT, rel), "rb") as f:
            now = hashlib.sha256(f.read()).hexdigest()
        assert now == digest, (
            f"{rel} changed since tests/torch_fixtures/{name}.npz was written:"
            " regenerate with tools/gen_port_fixtures.py")
    return d


def key(env_id: str) -> str:
    return env_id.replace("-v0", "")


def field_slices(cfg, tree):
    """(name, slice) of each non-empty field of the packed (NF, B) rows."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    rows, _ = fs._field_rows(cfg, tree)
    out, i = [], 0
    for name, r in rows:
        if r:
            out.append((name, slice(i, i + r)))
        i += r
    return out


def mpc_step_cost(cfg, w):
    """The cost_fn of the MPC step fixture (tools/gen_port_fixtures.py::
    mpc_step_cost), batched over (env, pop): trajectory_cost plus
    cost_params["reach"] (one weight per env) times the summed ee-to-block
    distance, read from the with_ee tail of the preview ags."""
    import torch
    from roboticsplayroompybullet_torch.solver import cost

    def cost_fn(ags, goals, acts, params):
        reach = torch.linalg.vector_norm(ags[..., -3:] - ags[..., 0:3],
                                         dim=-1).sum(-1)
        return (cost.trajectory_cost(cfg, ags, goals, acts, w)
                + params["reach"][:, None] * reach)
    return cost_fn


def zero_state(cfg, tree, B, device="cpu"):
    """An EnvState of B envs, every field zero (t, rng and has_prev of
    their dtypes): the template that fs.unpack_state fills from packed
    rows."""
    import torch
    from roboticsplayroompybullet_torch.envs.state import EnvState
    no = max(cfg.num_objects, 1)
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return EnvState(
        q=z(B, tree.n_dof), qd=z(B, tree.n_dof), ctrl_q=z(B, cfg.n_arm),
        grip=z(B), obj_pos=z(B, no, 3), obj_quat=z(B, no, 4),
        obj_vel=z(B, no, 3), obj_angvel=z(B, no, 3), art_q=z(B, 4),
        art_qd=z(B, 4), goal=z(B, cfg.goal_dim), prev_obs=z(B, cfg.obs_dim),
        prev_ag=z(B, cfg.ag_dim),
        has_prev=torch.zeros(B, dtype=torch.bool, device=device),
        rng=torch.zeros((B, 2), dtype=torch.int64, device=device),
        t=torch.zeros(B, dtype=torch.int32, device=device))


PIXEL_TOL = 1e-4      # per channel |Δ| of a float frame in [0, 1]
PIXEL_SHARE = 0.995   # of the pixels, in every channel


def pixel_rule(got, want):
    """(ok, outliers) of a float frame (..., H, W, 3) against another: per
    channel |Δ| ≤ PIXEL_TOL on at least PIXEL_SHARE of the pixels (a
    grazing ray at a primitive's edge may flip under another float32
    order), every value in [0, 1]. `outliers` counts the channel values
    off by more than PIXEL_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    off = np.abs(got - want) > PIXEL_TOL
    share = 1.0 - off.reshape(-1, 3).mean(0)
    ok = bool((share >= PIXEL_SHARE).all() and got.min() >= 0.0
              and got.max() <= 1.0)
    return ok, int(off.sum())

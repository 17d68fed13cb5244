"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py) and
of its checks on the card (chip_smoke.py, tools/check_fused_torch.py).

The JAX outputs the port is held to come from committed fixtures
(tests/torch_fixtures/*.npz, written by tools/gen_port_fixtures.py), so no
port test compiles the JAX lane twin. Each fixture records the sha256 of
the JAX sources it depends on; `load` refuses a stale one.
"""
import hashlib
import json
import os

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# the kernels against the plain twin on the card (chip_smoke.py and
# tools/check_fused_torch.py): the one-step bounds, the per-env and
# per-field judgement, and the plain twin replayed from CUDA graphs
# ---------------------------------------------------------------------------

POSITION_FIELDS = ("q", "obj_pos", "obj_quat", "art_q")
VELOCITY_FIELDS = ("qd", "obj_vel", "obj_angvel", "art_qd")
POS_MAX = 1e-4                      # position-like fields: max |Δ|
VEL_P99, VEL_MAX = 1e-3, 5e-2       # velocity fields: p99 and max |Δ|
MAX_FLIPS = 4                       # envs a step may leave the bounds above


def field_diffs(cfg, tree, A, B):
    """{field: (max, p99)} of |A - B| over the packed rows."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    rows, _ = fs._field_rows(cfg, tree)
    out, i = {}, 0
    d = (A - B).abs().cpu().numpy()
    for name, r in rows:
        if r:
            x = d[i:i + r]
            out[name] = (float(x.max()), float(np.quantile(x, 0.99)))
        i += r
    return out


def position_rows(cfg, tree, dev):
    """(NF,) bool: which packed rows hold a position-like field."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    rows, _ = fs._field_rows(cfg, tree)
    return torch.tensor([n in POSITION_FIELDS for n, r in rows
                         for _ in range(r)], device=dev)


def env_error(A, B, pos_rows):
    """(B,) each env's largest |A - B| over its rows, each row over its
    one-step bound (POS_MAX for positions, VEL_MAX for velocities): above 1
    is outside the one-step bounds."""
    lim = pos_rows.to(torch.float64) * (POS_MAX - VEL_MAX) + VEL_MAX
    return ((A - B).abs() / lim[:, None]).amax(0)


GRAPHS = {}     # (piece, input shapes and dtypes) -> its CUDA graph
WARM = {}       # (piece, dtypes) whose constants the twin has cached


def replay(cfg, piece, fn, *xs):
    """fn(*xs) (tensors in, a list of tensors out) replayed from a CUDA
    graph captured the first time cfg's `piece` meets these input shapes
    and dtypes; returns copies of the outputs. One eager call a piece and
    dtype first makes the constants the twin caches outside any capture.
    The graphs hold cfg, so its id names it until free_graphs()."""
    dtypes = tuple(x.dtype for x in xs)
    piece = (id(cfg),) + piece
    key = (piece, tuple(tuple(x.shape) for x in xs), dtypes)
    if key not in GRAPHS:
        static = [x.clone() for x in xs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        if (piece, dtypes) not in WARM:
            with torch.cuda.stream(side):
                fn(*static)
            WARM[piece, dtypes] = cfg
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*static)
        GRAPHS[key] = (static, graph, out, cfg)
    static, graph, out, _ = GRAPHS[key]
    for dst, x in zip(static, xs):
        dst.copy_(x)
    graph.replay()
    return [o.clone() for o in out]


def plain_sim(cfg, tree, arm, scene, n_substeps=None, solve_iters=8):
    """fs.make_reference_sim's plain twin, replayed a substep at a time.

    Eagerly the plain twin is host-bound (~10^5 small launches a control
    step, 7-11 s on the card's host whatever the batch); replayed, the
    same kernels on the same inputs run back to back, bit for bit
    (chip_smoke.py's twin phase holds that). A capture costs about one eager call of its
    piece, so the twin is captured a piece at a time, each reused at its
    shape: the first substep (a zero warm start), a warm-started one
    (make_lane_sim's loop), and the control (plain_step)."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    sub = fs.make_lane_substep(cfg, tree, arm, scene, solve_iters=solve_iters)
    n = cfg.substeps if n_substeps is None else n_substeps
    tag = ("substep", solve_iters)

    def substep(X, ctrl, grip, *lam):
        lam0 = [lam[i:i + 3] for i in range(0, len(lam), 3)] or None
        st, lam = sub(fs._lanes_from_block(cfg, tree, X), ctrl, grip, lam0)
        return [fs._block_from_lanes(cfg, tree, st)] + [
            t for trip in lam for t in trip]

    def sim_B(X, ctrl, grip):
        X, *lam = replay(cfg, tag + ("first",), substep, X, ctrl, grip)
        for _ in range(n - 1):
            X, *lam = replay(cfg, tag + ("warm",), substep, X, ctrl, grip,
                             *lam)
        return X

    return sim_B


def plain_step(cfg, tree, arm, scene, n_substeps=None, ik_iters=None,
               solve_iters=8, with_ctrl=False):
    """fs.make_reference_step's plain twin: its control replayed, then
    plain_sim."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    control = fs.make_lane_control(cfg, tree, arm, ik_iters=ik_iters)
    sim = plain_sim(cfg, tree, arm, scene, n_substeps, solve_iters)

    def ctl(X, actions):
        return list(control(fs._lanes_from_block(cfg, tree, X)["q"],
                            actions))

    def step_B(X, actions):
        ctrl, grip = replay(cfg, ("control", ik_iters), ctl, X, actions)
        X2 = sim(X, ctrl, grip)
        if with_ctrl:
            return X2, torch.cat([ctrl, grip[None]], dim=0)
        return X2

    return step_B


def plain_rollout(cfg, tree, arm, scene, horizon, n_substeps=None,
                  ik_iters=None, solve_iters=8, with_ee=False):
    """fs.make_reference_rollout's plain twin over plain_step."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    step = plain_step(cfg, tree, arm, scene, n_substeps=n_substeps,
                      ik_iters=ik_iters, solve_iters=solve_iters)
    ag_of = fs.make_lane_ag(cfg, tree, arm, with_ee)

    def roll_B(X, actions):
        ags = []
        for h in range(horizon):
            X = step(X, actions[h])
            ags.append(ag_of(X))
        return X, torch.stack(ags)

    return roll_B


def padded(fn, *xs):
    """fn(*xs) on envs (the last axis) padded to the next power of two, at
    least 8, with copies of the first env, and cut back: the twin's envs
    are independent columns, and few widths keep its graphs few."""
    n = xs[0].shape[-1]
    w = max(8, 1 << (n - 1).bit_length())
    out = fn(*(torch.cat([x, x[..., :1].expand(*x.shape[:-1], w - n)], -1)
               for x in xs))
    return out[..., :n]


def free_graphs():
    GRAPHS.clear()
    WARM.clear()
    torch.cuda.empty_cache()


def judge_step(cfg, tree, pos_rows, Xk, Yt):
    """One teacher-forced step: the kernel's next state Xk against the plain
    step Yt from the same state. Returns (per-field diffs, envs outside the
    one-step bounds, worst position max, fields whose p99 is over its
    one-step bound)."""
    diffs = field_diffs(cfg, tree, Xk, Yt)
    flips = int((env_error(Xk, Yt, pos_rows) > 1).sum())
    pmax = max(v[0] for k, v in diffs.items() if k in POSITION_FIELDS)
    over = [k for k, (_, p99) in diffs.items()
            if p99 > (POS_MAX if k in POSITION_FIELDS else VEL_P99)]
    return diffs, flips, pmax, over

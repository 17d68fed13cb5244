"""Start states from a configuration's pools: JAX-made state dumps copied
into portbench/data/, read as the configuration file's `pool` entries say.

A pool entry names an .npz file of portbench/data and either `packed`, the
key of a packed state (NF, N), or `fields`, a map from state field to key
(fields it lacks come from `const`, the rest are zero). `keep` drops the
envs whose blocks are off the table or still moving. The configuration's
`goal` is "field" (the dump's own goals) or "ag" (each env's goal the
achieved goal of another pool env, drawn from the seed).

Everything here is the benchmark's: the same numpy arrays go to the
program (as its EnvState) and to the reference (packed).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .reference import twin

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def field_rows(cfg, tree):
    """[(field, rows)] of the packed state, in the kernel's order."""
    return [(n, r) for n, r in twin._field_rows(cfg, tree)[0] if r]


def _entry(entry, cfg, tree):
    with np.load(os.path.join(DATA, entry["file"])) as z:
        d = {k: z[k] for k in z.files}
    rows = field_rows(cfg, tree)
    if "packed" in entry:
        X = d[entry["packed"]].astype(np.float32)
        fields, i = {}, 0
        N = X.shape[1]
        for name, r in rows:
            fields[name] = X[i:i + r].T.copy()
            i += r
        return fields, None, N
    fmap, const = entry["fields"], entry.get("const", {})
    N = d[fmap["q"]].shape[0]
    fields = {}
    for name, r in rows:
        if name in fmap:
            fields[name] = d[fmap[name]].reshape(N, r).astype(np.float32)
        elif name in const:
            fields[name] = np.tile(np.asarray(const[name], np.float32), (N, 1))
        else:
            fields[name] = np.zeros((N, r), np.float32)
    goal = d[entry["goal"]].astype(np.float32) if "goal" in entry else None
    keep = entry.get("keep")
    if keep and cfg.num_objects:
        pos = fields["obj_pos"].reshape(N, -1, 3)
        vel = fields["obj_vel"].reshape(N, -1, 3)
        ok = ((pos[..., 2] >= keep["obj_z_min"]).all(1)
              & (np.linalg.norm(vel, axis=-1) <= keep["obj_speed_max"]).all(1))
        fields = {k: v[ok] for k, v in fields.items()}
        goal = None if goal is None else goal[ok]
        N = int(ok.sum())
    return fields, goal, N


_LOADED: dict = {}


def load(config, model):
    """(fields {name: (N, rows) float32}, goals (N, goal_dim) or None) of
    the configuration's pool, its entries concatenated in order; read once
    a process."""
    key = (config["env_id"], repr(config["pool"]))
    if key not in _LOADED:
        _LOADED[key] = _load(config, model)
    return _LOADED[key]


def _load(config, model):
    cfg, tree = model[0], model[1]
    parts = [_entry(e, cfg, tree) for e in config["pool"]]
    fields = {k: np.concatenate([p[0][k] for p in parts])
              for k in parts[0][0]}
    goals = [p[1] for p in parts]
    goal = (np.concatenate(goals).astype(np.float32)
            if all(g is not None for g in goals) else None)
    return fields, goal


def packed(fields, cfg, tree):
    """(NF, N) float32 of the fields, in the kernel's row order."""
    return np.concatenate([fields[n].T for n, _ in field_rows(cfg, tree)]
                          ).astype(np.float32)


def achieved_goals(config, model):
    """(N, ag_dim) of the pool's states, by the reference's lane ag; worked
    out once a process."""
    key = (config["env_id"], repr(config["pool"]), "ag")
    if key not in _LOADED:
        cfg, tree, arm, _ = model
        X = torch.from_numpy(packed(load(config, model)[0], cfg, tree))
        _LOADED[key] = twin.make_lane_ag(cfg, tree, arm)(X).T.numpy(
        ).astype(np.float32)
    return _LOADED[key]


def draw(config, model, idx, rng, qd_noise=0.0):
    """The state dict (numpy, batch leading, every EnvState field) of the
    pool envs `idx`, with goals per the configuration and qd replaced by
    the seeded N(0, qd_noise²) of the port's
    chip_smoke.py::flagship_states (its grip and servo-target noise is
    left out: no packed state holds them, so no step reads them)."""
    cfg, tree, arm, _ = model
    fields, goal = load(config, model)
    B = len(idx)
    d = {k: v[idx] for k, v in fields.items()}
    if config["goal"] == "field":
        g = goal[idx]
    else:
        ags = achieved_goals(config, model)
        g = ags[rng.integers(0, ags.shape[0], B)]
    na, no = arm.n_arm, max(cfg.num_objects, 1)
    out = {"q": d["q"], "qd": d["qd"],
           "ctrl_q": d["q"][:, :na].copy(),
           "grip": np.zeros(B, np.float32),
           "art_q": d["art_q"], "art_qd": d["art_qd"], "goal": g,
           "prev_obs": np.zeros((B, cfg.obs_dim), np.float32),
           "prev_ag": np.zeros((B, cfg.ag_dim), np.float32),
           "has_prev": np.zeros(B, bool),
           "rng": np.zeros((B, 2), np.uint32),
           "t": np.zeros(B, np.int32)}
    for f, k in (("obj_pos", 3), ("obj_quat", 4), ("obj_vel", 3),
                 ("obj_angvel", 3)):
        out[f] = (d[f].reshape(B, no, k) if f in d
                  else np.zeros((B, no, k), np.float32))
    if qd_noise:
        out["qd"] = (rng.standard_normal(out["qd"].shape) * qd_noise
                     ).astype(np.float32)
    return out


def pool_size(config, model):
    return load(config, model)[0]["q"].shape[0]

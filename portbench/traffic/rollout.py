"""Closed-loop rollout traffic: one caller issues the port's whole-horizon
rollout (`parallel/fused.py::make_fused_rollout_whole`) back to back,
dispatched ahead, at most `in_flight` calls on the card at once.

Parameters (the workload file's `params`): `batch` B and `horizon` H;
`input_sets` batches of start states and actions drawn in set-up from the
seed and issued in turn; start states tiled from the configuration's pool
in a seeded order, qd drawn from N(0, `qd_noise`²); actions uniform in
[`action_low`, `action_high`]; `prefix_steps`, the steps over which every
env's gap is compared.

End to end: `rollouts_per_s`, the rollouts completed in the window over the
time from its start to the last completion. Correctness: one call, drawn
from the seed while the window runs (the others' outputs are let go, as a
collector's would be), is held once the window has closed to the plain
reference (portbench/reference) run free from the same start states and
actions.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import pools
from ..reference import build_model as reference_model
from ..reference.plain import Plain
from ..reference.rewards import compute_reward
from . import _compare


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.params
        self.dev = cell.device
        self.ref_model = reference_model(cell.config["env_id"])

    def setup(self):
        from roboticsplayroompybullet_torch import interop
        from roboticsplayroompybullet_torch.envs.config import CATALOG
        from roboticsplayroompybullet_torch.envs.core import build_model
        from roboticsplayroompybullet_torch.parallel import fused as F
        p, cfg = self.p, self.ref_model[0]
        B, H = int(p["batch"]), int(p["horizon"])
        rng = np.random.default_rng([self.cell.seed, 1])
        self.m = build_model(CATALOG[self.cell.config["env_id"]])
        n_pool = pools.pool_size(self.cell.config, self.ref_model)
        self.inputs = []
        for _ in range(int(p["input_sets"])):
            idx = np.resize(rng.permutation(n_pool), B)
            d = pools.draw(self.cell.config, self.ref_model, idx, rng,
                           qd_noise=p["qd_noise"])
            acts = rng.uniform(p["action_low"], p["action_high"],
                               (B, H, cfg.action_dim)).astype(np.float32)
            self.inputs.append((d, acts, interop.state_from_numpy(d, self.dev),
                                torch.from_numpy(acts).to(self.dev)))
        self.roll = F.make_fused_rollout_whole(self.m, H)
        with torch.no_grad():
            for _, _, st, a in self.inputs:
                self.roll(st, a)
        self.B, self.H = B, H
        self.check_rng = np.random.default_rng([self.cell.seed, 2])

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds):
        span = self.cell.spans.span
        cuda = self.dev.type == "cuda"
        depth = int(self.p["in_flight"])
        n, kept, events, done = 0, None, [], 0
        self._sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                g = n % len(self.inputs)
                _, _, st, a = self.inputs[g]
                with span("rollout.call"):
                    out = self.roll(st, a)
                n += 1
                if self.check_rng.integers(n) == 0:     # each call 1 in n
                    kept = (g, out)
                del out
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    events.append(ev)
                    if len(events) - done >= depth:
                        with span("rollout.wait"):
                            events[done].synchronize()
                        done += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            with span("rollout.drain"):
                self._sync()
        t_last = time.perf_counter()
        self.kept = kept
        return {"metrics": {"rollouts_per_s": (n * self.B / (t_last - t0),
                                               "rollouts/s")},
                "attempted": n * self.B, "failed": 0, "calls": n,
                "seconds": t_last - t0}

    def sample(self):
        """(start states, actions, and the program's packed final states,
        achieved goals, rewards and step counters) of the call the window
        kept; the program's other state is freed."""
        g, (fin, rew, ags) = self.kept
        d, acts, _, _ = self.inputs[g]
        cfg, tree = self.ref_model[0], self.ref_model[1]
        got = (_compare.packed_state(fin, cfg, tree), ags, rew, fin.t)
        self.kept = self.inputs = self.roll = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return (d, acts), got

    def reference(self, inputs, lower=False, plain=None):
        """The plain reference run free from the same start states and
        actions: (final states (NF, B), achieved goals (B, H, ag), rewards
        (B, H), step counters); with `lower`, one precision below (the
        control)."""
        d, acts = inputs
        cfg, tree = self.ref_model[0], self.ref_model[1]
        X0 = torch.from_numpy(pools.packed(
            {k: d[k].reshape(self.B, -1) for k, _ in
             pools.field_rows(cfg, tree)}, cfg, tree)).to(self.dev)
        A = torch.from_numpy(acts).to(self.dev).permute(1, 2, 0).contiguous()
        goal = torch.from_numpy(d["goal"]).to(self.dev)
        keep = plain is not None
        if not keep:
            plain = Plain(self.ref_model, lower=lower)
        with torch.no_grad():
            Xr, agr = plain.rollout(X0, A)
            agr = agr.permute(2, 0, 1)                       # (B, H, ag)
            with plain.precision():
                rwr = compute_reward(cfg, agr, goal[:, None, :])
        if not keep:
            plain.replay.free()
        return Xr, agr, rwr, torch.full_like(goal[:, 0], self.H), goal

    def numbers(self, got, ref):
        cfg, tree = self.ref_model[0], self.ref_model[1]
        return _compare.rollout_numbers(cfg, tree, got, ref,
                                        int(self.p["prefix_steps"]))

    def gaps(self, got, ref):
        return _compare.rollout_gaps(got, ref)

    def check(self):
        """The numbers of one call drawn from the seed against the plain
        reference run free from the same inputs."""
        inputs, got = self.sample()
        return self.numbers(got, self.reference(inputs))

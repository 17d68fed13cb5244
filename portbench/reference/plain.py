"""The plain twin at the benchmark's sizes: a control step, an H-step
rollout, the achieved goals, replayed from CUDA graphs on the card.

Eagerly the twin is host-bound (about 10^5 small launches a control step,
7-11 s on the card's host whatever the batch). Replayed, the same kernels
on the same inputs run back to back. A capture costs about one eager call
of its piece, so the twin is captured a piece at a time and each piece is
reused at its shape: the control, the first substep (a zero warm start) and
a warm-started substep. On the CPU every piece runs eagerly.

`lower=True` computes every piece one precision below the twin's own
(lowp.py): the benchmark's control, never its reference; `lower="float64"`
lowers the float64 control alone.
"""
from __future__ import annotations

import contextlib

import torch

from . import twin as fs
from .lowp import lower_precision


class Replayer:
    """fn(*xs) (tensors in, a list of tensors out) replayed from a CUDA
    graph captured the first time `key` meets these input shapes and
    dtypes; returns copies of the outputs. One eager call a key first makes
    the constants the twin caches outside any capture."""

    def __init__(self):
        self.graphs = {}
        self.warm = set()

    def __call__(self, key, fn, *xs):
        if xs[0].device.type != "cuda":
            return list(fn(*xs))
        gkey = (key, tuple(tuple(x.shape) for x in xs),
                tuple(x.dtype for x in xs))
        if gkey not in self.graphs:
            static = [x.clone() for x in xs]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            if key not in self.warm:
                with torch.cuda.stream(side):
                    fn(*static)
                self.warm.add(key)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = list(fn(*static))
            self.graphs[gkey] = (static, graph, out)
        static, graph, out = self.graphs[gkey]
        for dst, x in zip(static, xs):
            dst.copy_(x)
        graph.replay()
        return [o.clone() for o in out]

    def free(self):
        self.graphs.clear()
        self.warm.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class Plain:
    """The plain twin of one model (cfg, tree, arm, scene)."""

    def __init__(self, model, lower: bool = False):
        self.cfg, self.tree, self.arm, self.scene = model
        self.lower = lower
        self.replay = Replayer()
        self._made = {}

    def precision(self):
        """The context this twin computes in: its own precision, or one
        below."""
        if not self.lower:
            return contextlib.nullcontext()
        return lower_precision(None if self.lower is True else self.lower)

    def _piece(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def _run(self, key, fn, *xs):
        with self.precision():
            return self.replay((self.lower,) + key, fn, *xs)

    def sim(self, X, ctrl, grip, solve_iters=8):
        cfg, tree = self.cfg, self.tree
        sub = self._piece(("substep", solve_iters),
                          lambda: fs.make_lane_substep(
                              cfg, tree, self.arm, self.scene,
                              solve_iters=solve_iters))

        def substep(X, ctrl, grip, *lam):
            lam0 = [lam[i:i + 3] for i in range(0, len(lam), 3)] or None
            st, lam = sub(fs._lanes_from_block(cfg, tree, X), ctrl, grip,
                          lam0)
            return [fs._block_from_lanes(cfg, tree, st)] + [
                t for trip in lam for t in trip]

        X, *lam = self._run(("first", solve_iters), substep, X, ctrl, grip)
        for _ in range(cfg.substeps - 1):
            X, *lam = self._run(("warm", solve_iters), substep, X, ctrl, grip,
                                *lam)
        return X

    def step(self, X, actions, ik_iters=None, solve_iters=8):
        """X (NF, B), actions (A, B) → X' after one control step."""
        cfg, tree = self.cfg, self.tree
        control = self._piece(("control", ik_iters),
                              lambda: fs.make_lane_control(
                                  cfg, tree, self.arm, ik_iters=ik_iters))

        def ctl(X, actions):
            return list(control(fs._lanes_from_block(cfg, tree, X)["q"],
                                actions))

        ctrl, grip = self._run(("control", ik_iters), ctl, X, actions)
        return self.sim(X, ctrl, grip, solve_iters)

    def ag(self, X):
        """Achieved goals (ag_dim, B) of the packed state X."""
        ag_of = self._piece(("ag",), lambda: fs.make_lane_ag(
            self.cfg, self.tree, self.arm))
        return self._run(("ag",), lambda X: [ag_of(X)], X)[0]

    def rollout(self, X, actions, ik_iters=None, solve_iters=8):
        """X (NF, B), actions (H, A, B) → (X', ags (H, ag_dim, B))."""
        ags = []
        for a in actions:
            X = self.step(X, a, ik_iters, solve_iters)
            ags.append(self.ag(X))
        return X, torch.stack(ags)

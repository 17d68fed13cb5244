"""Closed-loop receding-horizon control: one controller replans with the
port's fused MPPI planner (`solver/mpc.py::make_fused_planner`), executes
the plan's first action through `parallel/fused.py::
make_fused_batched_step` at B=1, scores it (`envs/obs.py::achieved_goal`,
`envs/rewards.py::compute_reward`), shifts the plan and reads the action
back to the host, as a robot controller must, then starts the next step.

Parameters (the workload file's `params`): the planner's `pop`, `horizon`,
`iters`; `episode_steps` control steps an episode; each episode starts
from a pool state and a goal drawn from the seed, its plan holding the
start pose (`init_plan_from_state`); each control step seeds the planner's
generator with its own number drawn from the seed; the window runs for its
seconds (and one step at least); `check_steps` control steps drawn from the
seed are checked.

End to end: `mpc_step_ms`, the window's time over the control steps
completed, and `mpc_step_ms_p95`, the 95th percentile of every step's
latency, from its planner call to the action on the host. Correctness,
once the window has closed: each checked step's replan is computed again
by the plain reference (portbench/reference/mppi.py) from the same state,
plan and normals, and its executed step from the same state and the
program's own action; the episodes' start plans are computed again from
their start states.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import pools
from ..reference import build_model as reference_model
from ..reference.mppi import MPPIConfig, execute, replan
from ..reference.plain import Plain
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
        from roboticsplayroompybullet_torch.envs.obs import achieved_goal
        from roboticsplayroompybullet_torch.envs.rewards import compute_reward
        from roboticsplayroompybullet_torch.parallel import fused as F
        from roboticsplayroompybullet_torch.solver import mpc
        p = self.p
        self.mpc = mpc
        self.cfg = mpc.MPCConfig(horizon=int(p["horizon"]), pop=int(p["pop"]),
                                 iters=int(p["iters"]), algorithm="mppi")
        self.m = build_model(CATALOG[self.cell.config["env_id"]])
        m = self.m
        rng = np.random.default_rng([self.cell.seed, 1])
        n_pool = pools.pool_size(self.cell.config, self.ref_model)
        n_ep = int(p["episodes"])
        d = pools.draw(self.cell.config, self.ref_model,
                       rng.integers(0, n_pool, n_ep), rng)
        d["goal"] = d["goal"][rng.integers(0, n_ep, n_ep)]
        pool = interop.state_from_numpy(d, self.dev)
        self.starts = [pool.replace(**{f: getattr(pool, f)[i:i + 1] for f in
                                       interop.FIELDS}) for i in range(n_ep)]
        self.plans = [mpc.PlanState(*(x[0] for x in mpc.init_plan_from_state(
            m, self.cfg, s))) for s in self.starts]
        self.planner = mpc.make_fused_planner(m, self.cfg)
        self.stepper = F.make_fused_batched_step(m)
        self.gen = torch.Generator(device=self.dev)

        def score(st):
            return compute_reward(m.cfg, achieved_goal(m.cfg, m.tree, m.arm,
                                                       st), st.goal)
        self.score = score
        with torch.no_grad():             # every shape of the window, twice
            for e in range(2):
                self._control(self.starts[e], self.plans[e], 0)
        self.check_rng = np.random.default_rng([self.cell.seed, 2])
        self.seed_rng = np.random.default_rng([self.cell.seed, 3])

    def _control(self, state, plan, seed, span=None):
        """One control step: (next state, its plan, the record)."""
        if span is None:
            span = self.cell.spans.span
        t0 = time.perf_counter()
        self.gen.manual_seed(int(seed))
        with span("mpc.plan"):
            new, best = self.planner(state, plan, self.gen)
        with span("mpc.exec"):
            a = new.mean[0]
            nxt = self.stepper(state, a[None])
            rew = self.score(nxt)
        shifted = self.mpc.shift_plan(new, self.cfg)
        t1 = time.perf_counter()
        with span("mpc.readback"):
            a.cpu()
        t2 = time.perf_counter()
        rec = (state, plan, int(seed), new.mean, best, nxt, rew,
               t1 - t0, t2 - t0)
        return nxt, shifted, rec

    def window(self, seconds):
        span = self.cell.spans.span
        steps, n_ep, k = [], len(self.starts), int(self.p["episode_steps"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        e, done = 0, False
        with torch.no_grad():
            while not done:
                state, plan = self.starts[e % n_ep], self.plans[e % n_ep]
                for _ in range(k):
                    state, plan, rec = self._control(
                        state, plan, self.seed_rng.integers(2 ** 62), span)
                    steps.append(rec)
                    done = time.perf_counter() - t0 >= seconds
                    if done:
                        break
                e += 1
        t_end = time.perf_counter()
        self.steps = steps
        self.episodes_used = e
        lat = np.array([r[8] for r in steps]) * 1e3
        return {"metrics": {
                    "mpc_step_ms": ((t_end - t0) * 1e3 / len(steps), "ms"),
                    "mpc_step_ms_p95": (float(np.percentile(lat, 95)), "ms")},
                "attempted": len(steps), "failed": 0, "steps": len(steps),
                "enqueue_ms": [r[7] * 1e3 for r in steps],
                "seconds": t_end - t0}

    def sample(self):
        """The inputs and the program's outputs of `check_steps` control
        steps drawn from the seed: (X (NF, k), goal (k, gd), plan mean and
        sigma (k, H, A), step seeds), (mean (k, H, A), best (k,), X' (NF,
        k), reward (k,)). The program's other state is freed."""
        cfg, tree = self.ref_model[0], self.ref_model[1]
        n = min(int(self.p["check_steps"]), len(self.steps))
        pick = sorted(self.check_rng.choice(len(self.steps), n,
                                            replace=False))
        recs = [self.steps[i] for i in pick]
        cat = torch.cat
        inputs = (cat([_compare.packed_state(r[0], cfg, tree) for r in recs],
                      1),
                  cat([r[0].goal for r in recs]),
                  torch.stack([r[1].mean for r in recs]),
                  torch.stack([r[1].sigma for r in recs]),
                  [r[2] for r in recs])
        used = range(min(self.episodes_used, len(self.starts)))
        got = (torch.stack([r[3] for r in recs]),
               torch.stack([r[4].reshape(()) for r in recs]),
               cat([_compare.packed_state(r[5], cfg, tree) for r in recs], 1),
               cat([r[6].reshape(1) for r in recs]),
               torch.stack([self.plans[e].mean for e in used]))
        inputs = inputs + (cat([_compare.packed_state(self.starts[e], cfg,
                                                      tree) for e in used],
                               1), got[0][:, 0])
        self.steps = self.starts = self.plans = None
        self.planner = self.stepper = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return inputs, got

    def reference(self, inputs, lower=False, plain=None):
        """The plain reference's replans of the same states, plans and
        normals, its executed steps of the same states and the program's
        own actions, and the plans that hold the episodes' start poses (one
        precision below with `lower`)."""
        X, goal, mean, sigma, seeds, starts, action = inputs
        rc = MPPIConfig(horizon=self.cfg.horizon, pop=self.cfg.pop,
                        iters=self.cfg.iters,
                        temperature=self.cfg.temperature,
                        smooth=self.cfg.smooth,
                        preview_ik_iters=self.cfg.preview_ik_iters,
                        preview_solve_iters=self.cfg.preview_solve_iters)
        gens = [torch.Generator(device=self.dev).manual_seed(s)
                for s in seeds]
        shape = (rc.pop,) + tuple(mean.shape[1:])
        noises = [torch.stack([torch.randn(shape, generator=g,
                                           dtype=torch.float32,
                                           device=self.dev) for g in gens])
                  for _ in range(rc.iters)]
        high = torch.tensor(self.ref_model[0].action_high,
                            dtype=torch.float32, device=self.dev)
        keep = plain is not None
        if not keep:
            plain = Plain(self.ref_model, lower=lower)
        cfg, tree, arm, _ = self.ref_model
        with torch.no_grad(), plain.precision():
            mean, best = replan(plain, rc, X, goal, mean, sigma, noises,
                                high)
            X2, reward = execute(plain, X, action, goal)
            hold = _compare.hold_plan(cfg, tree, arm, starts, rc.horizon)
        if not keep:
            plain.replay.free()
        return mean, best, X2, reward, hold, goal

    def numbers(self, got, ref):
        cfg, tree, arm, _ = self.ref_model
        return _compare.mpc_numbers(cfg, tree, arm, got, ref)

    def gaps(self, got, ref):
        return _compare.mpc_gaps(got, ref)

    def check(self):
        inputs, got = self.sample()
        return self.numbers(got, self.reference(inputs))

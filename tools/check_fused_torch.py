"""Full-fidelity sweep of the port's kernels against the JAX package's vmap
oracle, field by field: the PyTorch port's counterpart of
tools/check_fused.py.

For each env id the oracle's outputs come from a committed fixture
(tests/torch_fixtures/fidelity_<id>.npz, which tools/gen_port_fixtures.py
writes on the CPU from the unchanged JAX package): 64 start states, 16 of
them placed in contact, the oracle's run_simulation from their servo
targets and grip, its step_physics_only on numpy-drawn actions (with the
servo targets and grip it sets), JAX's own lane twin's gap to the oracle per
field, the oracle's own spread under a one-ulp change of its inputs, and
each contact-row family's active rows. Here the hand-written
fs_sim and fs_step kernels run on the same inputs at the same fidelity (the
config's 12 substeps, 8 warm-started Jacobi iterations, the arm's IK
iterations), the port's plain twin beside them, and one markdown table per
id and level (sim, step) gives each field's

- kernel - oracle (max / mean / p99 / p99.9),
- JAX lane - oracle (max / mean / p99 / p99.9, from the fixture), and the
  oracle's own one-ulp spread (max / p99.9; shown, not a gate),
- kernel - the port's plain twin (max / p99).

    python tools/check_fused_torch.py                       # JAX's 3 ids
    python tools/check_fused_torch.py --all                 # the 19 ids
    python tools/check_fused_torch.py UR5Reach-v0 --device cpu

On the card (the default) the kernels run; with --device cpu the plain
twin stands in the kernel's column, the header says so, and the third
column is empty. It never falls back to the CPU by itself. It exits 1 if a
gate fails:

- against the oracle, the bounds the JAX package holds its lane twin to:
  every field of the sim max <= 1e-4 (tools/check_fused.py); the step as
  tests/test_fused.py::test_fused_full_step_matches holds it (positions max
  <= 5e-4; velocities p99.9 < 5e-4, max < 5e-3), its servo targets as
  test_fused_control_matches does (p99 < 1e-3, max < 0.1; grip max <=
  1e-6). Where the fixture shows JAX's lane twin already past a bound,
  that (field, statistic) is widened to the lane twin's figure plus the
  port's kernel-vs-twin term (positions 1e-4, velocities 1e-3), and
  printed. No other bound is widened;
- against the plain twin, the one-step bounds of tests/_torch_port.py
  (judge_step: positions max <= 1e-4; velocities max <= 5e-2; no field's
  p99 over 1e-4 for positions, 1e-3 for velocities; the servo targets and
  grip count as positions) with at most ceil(4 * B / 4096) = 1 env outside
  them;
- no vacuous pass: every contact-row family the model has (block vs
  world, block vs block, block vs element, pad vs block, pad vs world,
  pad vs element; cuda_build.row_table) has an active row in the fixture.

A field outside its bound is reported with the envs that leave it. Where
that is one env listed in RECORDED, a place where the oracle itself lies
farther than the bound from the same physics run in float64 (the
reference's gap, ROADMAP Queue 3), the failure is marked as recorded, the
other envs of the field are held to the bound, and chip_smoke.py does not
stop for it; the sweep still fails.
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_port as tp  # noqa: E402

# tools/check_fused.py's DEFAULT_ENVS: both arms and the two-block scene
DEFAULT_ENVS = ("UR5PlayAbsRPY1Obj-v0", "pandaPlayAbsRPY1Obj-v0",
                "pandaPlay-v0")
POSITIONS = ("q", "obj_pos", "obj_quat", "art_q", "targets", "grip")
# what a widened bound adds to JAX's lane twin's figure (PERF.md §2)
PORT_TERM = {"position": 1e-4, "velocity": 1e-3}
FAMILY_OF_ROW = ("block_world", "block_world", "block_art", "pad_block",
                 "block_block", "pad_art", "pad_world", "pad_world")
STATS = ("max", "mean", "p99", "p99.9")
# The reference's gaps (ROADMAP Queue 3), {(id, level, field): env}: the one
# env at which the kernel leaves JAX's bound, where the oracle is farther
# than that bound from the port's plain twin run in float64. Env 36 of the
# Panda ids: an ill-conditioned IK solve, which the oracle does by float32
# LU (5.115e-4 from the float64 step against the 5e-4 bound). Env 54 of the
# Panda one-block play ids: pad 0 pressed 2 mm into the table, where the
# float32 sim parts from the float64 one by up to 3.9e-4 in a finger's qd
# (the oracle 1.25e-4 from it against the 1e-4 bound).
RECORDED = dict(
    [((e, "step", "q"), 36) for e in (
        "pandaReach-v0", "pandaReach2D-v0", "pandaPush-v0", "pandaPick-v0",
        "pandaPlayAbsRPY1Obj-v0")]
    + [((e, "sim", "qd"), 54) for e in (
        "pandaPlay1Obj-v0", "pandaPlayRel1Obj-v0",
        "pandaPlayRelJoints1Obj-v0", "pandaPlayAbsJoints1Obj-v0",
        "pandaPlayAbsRPY1Obj-v0", "pandaPlayRelRPY1Obj-v0")])


def kind(field: str) -> str:
    return "position" if field in POSITIONS else "velocity"


def oracle_limits(level: str, field: str) -> list:
    """[(statistic, limit, strict)] the JAX package holds its lane twin to
    against the oracle, for one field of one level."""
    if level == "sim":
        return [("max", 1e-4, False)]
    if field == "targets":
        return [("p99", 1e-3, True), ("max", 0.1, True)]
    if field == "grip":
        return [("max", 1e-6, False)]
    if kind(field) == "position":
        return [("max", 5e-4, False)]
    return [("p99.9", 5e-4, True), ("max", 5e-3, True)]


def within(x: float, limit: float, strict: bool) -> bool:
    return x < limit if strict else x <= limit


def gate(level: str, field: str, lane: dict) -> list:
    """[(statistic, limit, strict, lane figure or None)]: oracle_limits,
    with each limit that JAX's lane twin's gap to the oracle (lane, per
    statistic, from the fixture) does not keep widened to that figure plus
    PORT_TERM of the field's kind; the figure is given where a limit was
    widened."""
    out = []
    for stat, limit, strict in oracle_limits(level, field):
        j = lane[stat]
        if within(j, limit, strict):
            out.append((stat, limit, strict, None))
        else:
            out.append((stat, j + PORT_TERM[kind(field)], False, j))
    return out


def stats(a, b) -> dict:
    """max, mean, p99, p99.9 of |a - b| over every element."""
    x = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return dict(zip(STATS, (float(x.max()), float(x.mean()),
                            float(np.quantile(x, 0.99)),
                            float(np.quantile(x, 0.999)))))


def judge_field(env_id, level, field, got, want, lane) -> tuple:
    """One field of one level against the oracle, (rows, B) each: (its
    stats, its gate, failures [(stat, value, limit, envs past the limit)],
    recorded). The failure is recorded where RECORDED names this (id,
    level, field), that env is the only one past a limit, and the other
    envs keep every limit."""
    s = stats(got, want)
    g = gate(level, field, lane)
    B = got.shape[-1]
    per_env = np.abs(np.asarray(got, np.float64) - want).reshape(-1, B).max(0)
    fails = [(stat, s[stat], limit, np.flatnonzero(per_env > limit).tolist())
             for stat, limit, strict, _ in g
             if not within(s[stat], limit, strict)]
    env = RECORDED.get((env_id, level, field))
    recorded = False
    if fails and env is not None and all(e == [env] for *_, e in fails):
        keep = np.arange(B) != env
        rest = stats(got[..., keep], want[..., keep])
        recorded = all(within(rest[stat], limit, strict)
                       for stat, limit, strict, _ in g)
    return s, g, fails, recorded


def twin_judge(m, got, twin) -> tuple:
    """The kernel against the plain twin by tp.judge_step: got and twin are
    (packed X (NF, B), servo targets and grip (n_arm + 1, B) or None), the
    servo targets and grip judged as position rows. Returns ({field: (max,
    p99)}, envs outside the one-step bounds, ok): at most
    ceil(MAX_FLIPS * B / 4096) envs outside, no field's p99 over its
    bound."""
    cfg, tree = m.cfg, m.tree
    (Xk, ck), (Xt, ct) = got, twin
    pos = tp.position_rows(cfg, tree, Xk.device)
    B = Xk.shape[-1]
    if ck is not None:
        Xk, Xt = torch.cat([Xk, ck]), torch.cat([Xt, ct])
        pos = torch.cat([pos, torch.ones(len(ck), dtype=torch.bool,
                                         device=pos.device)])
    diffs, flips, _, over = tp.judge_step(cfg, tree, pos, Xk, Xt)
    if ck is not None:
        d = (ck - ct).abs().cpu().numpy()
        for f, x in (("targets", d[:-1]), ("grip", d[-1:])):
            diffs[f] = (float(x.max()), float(np.quantile(x, 0.99)))
            if diffs[f][1] > tp.POS_MAX:
                over.append(f)
    ok = flips <= math.ceil(tp.MAX_FLIPS * B / 4096) and not over
    return diffs, flips, ok


def coverage(m, z: dict) -> tuple:
    """({family: (rows, active rows)} of the fixture, the families without
    an active row, and the families whose row count disagrees with the
    port's row table (cuda_build.row_table: the kernel's rows) times B)."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    B = z["X"].shape[1]
    table = {}
    for r in cuda_build.row_table(m.cfg, m.scene,
                                  [0] * len(m.arm.pad_spheres)):
        f = FAMILY_OF_ROW[r["kind"]]
        table[f] = table.get(f, 0) + B
    have = {str(f): (int(n), int(a))
            for f, n, a in zip(z["families"], z["rows"], z["active"])}
    idle = [f for f, (n, a) in have.items() if n and not a]
    differ = sorted(f for f in set(table) | set(have)
                    if table.get(f, 0) != have.get(f, (0, 0))[0])
    return have, idle, differ


def load(env_id: str) -> dict:
    return tp.load(f"fidelity_{tp.key(env_id)}")


def split(cfg, tree, X) -> dict:
    """{field: rows} of packed (NF, B) rows, the non-empty fields."""
    return {name: X[sl] for name, sl in tp.field_slices(cfg, tree)}


def run_level(level, m, z, dev, plain):
    """(the kernel's (or on the CPU the plain twin's) outputs, the plain
    twin's or None) of one level on the fixture's inputs, each (packed X,
    servo targets and grip or None) on dev. `plain` makes the plain twin:
    (make_sim, make_step) with fs.make_reference_sim / _step's signatures,
    or None to skip it."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    T = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa
    on_card = dev.type == "cuda"
    with torch.no_grad():
        if level == "sim":
            args = (T(z["X"]), T(z["ctrl"]), T(z["grip"]))
            make = fs.make_cuda_sim if on_card else fs.make_reference_sim
            outs = [(make(*m)(*args), None)]
            if on_card and plain is not None:
                outs.append((plain[0](*m)(*args), None))
        else:
            args = (T(z["X"]), T(z["actions"]))
            make = fs.make_cuda_step if on_card else fs.make_reference_step
            outs = [make(*m, with_ctrl=True)(*args)]
            if on_card and plain is not None:
                outs.append(plain[1](*m, with_ctrl=True)(*args))
    return outs[0], (outs[1] if len(outs) > 1 else None)


def fields_of(m, out) -> dict:
    """{field: numpy rows} of run_level's (packed X, targets and grip)."""
    X, c = (None if t is None else t.cpu().numpy() for t in out)
    d = split(m.cfg, m.tree, X)
    if c is not None:
        d["targets"], d["grip"] = c[:-1], c[-1:]
    return d


def oracle(level: str, m, z: dict) -> dict:
    d = split(m.cfg, m.tree, z[f"{level}_X"])
    if level == "step":
        d["targets"], d["grip"] = z["step_ctrl"], z["step_grip"][None]
    return d


def _fmt(s: dict, keys=STATS) -> str:
    return " / ".join(f"{s[k]:.2e}" for k in keys)


def check_env(env_id: str, dev, plain=None, say=print) -> dict:
    """The sweep on one id (see the module's docstring): prints its two
    tables and returns {"ok", "levels": {level: {"worst", "twin_flips",
    "twin_ok", "twin_run"}}, "widened": [...],
    "failed": [...], "recorded": [the failures that are RECORDED gaps],
    "worst": (level, field, ratio), "coverage": {...}, "launches": {...}}.
    `plain` as run_level's; on the CPU the plain twin is the kernel's
    column and `plain` is not used."""
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    t0 = time.perf_counter()
    dev = torch.device(dev)
    m = core.build_model(CATALOG[env_id])
    z = load(env_id)
    B = z["X"].shape[1]
    on_card = dev.type == "cuda"
    have, idle, differ = coverage(m, z)
    res = {"env_id": env_id, "B": B, "levels": {}, "widened": [],
           "failed": [], "recorded": [], "worst": ("", "", 0.0),
           "coverage": have}
    who = "kernel" if on_card else "plain twin (no kernel on the CPU)"
    for f in idle:
        res["failed"].append(f"contact family {f}: no active row")
    for f in differ:
        res["failed"].append(f"contact family {f}: rows differ from the "
                             "kernel's row table")
    fs.reset_launch_counts()
    for level in ("sim", "step"):
        out, twin = run_level(level, m, z, dev, plain)
        got, want = fields_of(m, out), oracle(level, m, z)
        tdiff, flips, tok = twin_judge(m, out, twin) if twin else ({}, 0,
                                                                  True)
        say(f"\n### {env_id} · {level} (B={B}, {int(z['n_substeps'])} "
            f"substeps, {int(z['solve_iters'])} warm-started iterations; "
            f"first column: the {who})\n")
        say(f"| field | {who} − oracle max / mean / p99 / p99.9 | JAX "
            "lane − oracle max / mean / p99 / p99.9 | oracle one-ulp spread "
            "max / p99.9 (not a gate) | kernel − plain twin max / p99 | "
            "gate against the oracle | |")
        say("|---|---|---|---|---|---|---|")
        lworst = ("", 0.0)
        for f in got:
            lane = dict(zip(STATS, map(float, z[f"jax_{level}_{f}"])))
            ulp = dict(zip(STATS, map(float, z[f"ulp_{level}_{f}"])))
            s, g, fails, recorded = judge_field(env_id, level, f, got[f],
                                                want[f], lane)
            ratio = max(s[stat] / limit for stat, limit, _, _ in g)
            text = [f"{stat} {'<' if strict else '≤'} {limit:.1e}"
                    + ("*" if jfig is not None else "")
                    for stat, limit, strict, jfig in g]
            for stat, limit, _, jfig in g:
                if jfig is not None:
                    res["widened"].append(dict(
                        level=level, field=f, stat=stat, jax=jfig,
                        limit=limit, base=dict(
                            (k, v) for k, v, _ in oracle_limits(level, f))
                        [stat]))
            for stat, v, limit, envs in fails:
                msg = (f"{level} {f}: {stat} {v:.3e} against the oracle, "
                       f"limit {limit:.3e}, envs {envs}")
                res["failed"].append(msg)
                if recorded:
                    res["recorded"].append(msg)
            if ratio > lworst[1]:
                lworst = (f, ratio)
            tw = _fmt(dict(zip(("max", "p99"), tdiff[f])), ("max", "p99")) \
                if f in tdiff else "—"
            verdict = ("ok" if not fails else
                       "FAIL (recorded: ROADMAP Queue 3)" if recorded
                       else "FAIL")
            say(f"| {f} | {_fmt(s)} | {_fmt(lane)} | "
                f"{_fmt(ulp, ('max', 'p99.9'))} | {tw} | {', '.join(text)} "
                f"| {verdict} |")
        if twin:
            say(f"\nkernel − plain twin: {flips} of {B} envs outside the "
                "one-step bounds (at most "
                f"{math.ceil(tp.MAX_FLIPS * B / 4096)}): "
                f"{'ok' if tok else 'FAIL'}")
            if not tok:
                res["failed"].append(f"{level}: kernel − plain twin outside "
                                     f"the one-step bounds ({flips} envs)")
        res["levels"][level] = dict(worst=lworst,
                                    twin_flips=flips, twin_ok=tok,
                                    twin_run=twin is not None)
        if lworst[1] > res["worst"][2]:
            res["worst"] = (level,) + lworst
    res["launches"] = dict(fs.LAUNCHES)
    for w in res["widened"]:
        say(f"widened: {w['level']} {w['field']} {w['stat']} "
            f"{w['base']:.1e} → {w['limit']:.3e} (JAX's lane twin "
            f"{w['jax']:.3e})")
    say("contact rows (rows, active): " + ", ".join(
        f"{f} {n}/{a}" for f, (n, a) in have.items()))
    res["ok"] = not res["failed"]
    res["seconds"] = time.perf_counter() - t0
    lvl, f, ratio = res["worst"]
    say(f"{env_id}: {'PASS' if res['ok'] else 'FAIL'} (worst against the "
        f"oracle: {lvl} {f} at {ratio:.3f} of its gate; "
        f"{res['seconds']:.1f} s)"
        + "".join(f"\n  FAIL {x}"
                  + (" (recorded: ROADMAP Queue 3)"
                     if x in res["recorded"] else "")
                  for x in res["failed"]))
    return res


def main(argv=None) -> int:
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ids", nargs="*", help="env ids (default: JAX's "
                    "DEFAULT_ENVS of tools/check_fused.py)")
    ap.add_argument("--all", action="store_true", help="all 19 ids")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ids = list(CATALOG) if args.all else (args.ids or list(DEFAULT_ENVS))
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run the plain twin",
              file=sys.stderr)
        return 2
    plain, free = None, (lambda: None)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
        # the plain twin replayed from CUDA graphs, bit for bit the eager
        plain, free = (tp.plain_sim, tp.plain_step), tp.free_graphs
    results = []
    for e in ids:
        results.append(check_env(e, args.device, plain))
        free()
    bad = [r["env_id"] for r in results if not r["ok"]]
    new = [r["env_id"] for r in results
           if len(r["failed"]) > len(r["recorded"])]
    print(f"\nSWEEP {'PASS' if not bad else 'FAIL'} over {len(ids)} ids"
          + (f": {bad} failed, {new} outside the recorded gaps (ROADMAP "
             "Queue 3)" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Builds the hand-written CUDA kernel (roboticsplayroompybullet_torch/csrc/
fused_step.cu) from this checkout (and fails if an entry point's stack
frame is over 1 KB or anything spills), holds each of its three entry points
(sim, step, rollout) to the plain PyTorch lane twin on the card and to the
JAX package's outputs (committed fixtures, tests/torch_fixtures/), then
drives the port's main path — make_fused_rollout_whole(m, 40) on
UR5PlayAbsRPY1Obj-v0 at B=4096, plus the env step and the sim kernel —
holds its rollout to the plain twin at that same shape, and times it with
CUDA events: each kernel beside its plain version and its bound (FLOPs
counted from the source over 67 TFLOP/s, bytes over 3.35 TB/s), the batch
scaling, and the rollout's split into Jacobi sweeps / IK / the rest.
Then the MPC slice (solver/mpc.py): the planners' preview model (ik 8 /
solve 8, with_ee) against the plain twin, one batched MPC step through the
kernels against the plain twin and against the JAX fixture, the MPC path
(a flagship replan at 1024 candidates, an eval control step at 4 envs x
1024 and the UR5Reach closed loop, which must close the EE-goal distance
below 0.75 of its start in 20 steps) with its launch counts, each of its
kernel launches held to the plain twin at the path's own shapes and
inputs (the H=10 previews step by step, the B=4 and B=1 executed steps),
and its times: ms per replan (pop=1024, H=10, 2 iterations) beside the
preview kernel's, ms per eval control step split into previews and the
executed step.
Then the multi-device layer (parallel/mesh.py, the sharded paths,
tools/launch_distributed_torch.py): `[multi]` starts NCCL at world size 1
on the card, runs make_sharded_fused_rollout on the main path's inputs
(B=4096, H=40) and the sharded fused planner (pop=1024, H=10) by MPPI and
by CEM, each of which must equal its unsharded counterpart bit for bit,
dryrun_multichip(1), and the launcher (3 steps, a checkpoint, a relaunch
that resumes from it); it prints the sharded times beside the unsharded
ones and, from a torch.profiler trace of the sharded replan, its NCCL
kernels' device time and its host time inside the collective calls.
Then the env layer (envs/core.py, envs/wrapper.py, parallel/rollout.py):
`[env golden]` replays the 19 goldens through PlayEnv on the card (the
step kernel at B=1), free-running against the golden and teacher-forced
against the JAX lane twin's replay (fixtures golden_lane_*); `[env reset]`
runs batched_reset at B=4096 on the flagship and the 2-block pandaPlay
(the settle is one sim-kernel launch of 100 substeps a placement
attempt; one such launch is held to the plain twin) and the out-of-bounds
re-place case at B=1024; `[env step]` steps BatchedEnv at B=4096 (one
step held to the plain twin) and times it beside PlayEnv.step at B=1;
`[render]` drives the camera path (utils/render.py, PlayEnv.render and
obs["img"], the sub-goal ghosts, tools/teleop_bridge_torch.py) on the
flagship at 200x200: reset, render, recorded steps (one step launch
each), a sub-goal drawn and deleted, the human PNG, a bridge on the card;
every frame held to the port's CPU render of the same state by the pixel
rule, and the ms of a frame at B=1 and B=64;
`[mpc plan loop]` runs mpc_rollout on UR5Reach (the planner scoring at the
env step's fidelity) and holds its kernel launches at their own shapes.
Then the task-competence eval (solver/eval.py): `[eval]` runs run_eval
for the 12 families of tools/eval_mpc_torch.py at full width (4 envs x
1024 candidates, H=10) on one batch of 5 steps, holds the first preview
launch of each model new to the MPC path (UR5Reach, pandaPlayAbsRPY1Obj,
pandaPick at B=4096) step by step and every model's executed step and
pick's acquisition step per field, and times each model's eval control
step (`[eval step]`).
Then the learning-from-play chain (learn/, tools/collect_play_torch.py,
tools/train_lfp_torch.py, tools/eval_lfp_torch.py): `[lfp]` collects
1024 play episodes x 24 steps on the flagship through the step kernel
(its first step launch held to the plain step per field), writes the
episode log and reads it back bit for bit, trains the 512x512 policy 200
Adam steps on batches of 256 windows x 16 (the loss must fall; the
forward on the card must equal the CPU's) and runs the window-goal eval
of 64 episodes (finite metrics in LFP_EVAL.json's schema), printing each
stage's time.
Then the gradient solvers (solver/ilqr.py, solver/gradient.py): `[ilqr]`
runs ilqr_plan on UR5Reach (12 substeps, H=10, 3 iterations), refine on
UR5Reach (2 Adam steps) and ilqr_plan through contact on pandaPick's
scripted pinch (H=3, 2 iterations): each must end finite and strictly
below its start, every forward pass a step launch (counted), with each
iteration's time split into linearisation, Riccati and line search.
Each model's graphed VJP (the plain twin's, replayed as a CUDA graph),
at states other than the one it was captured at (10 x 52 UR5Reach envs,
3 x 47 at the pinch), is held to the twin's plain autograd.
Every phase prints its numbers and its time; any failure raises and the
script exits non-zero without a result line. The plain twin is
host-bound (~10^5 small launches a control step, 7-11 s whatever the
batch): the twin phase calls it eagerly once a kernel (its time is the
plain version's) and holds its replay from CUDA graphs (plain_sim /
plain_step / plain_rollout, a piece at a time) equal to it bit for bit;
every later check steps that replay. The captures of the solvers' VJP
graphs and the eager autograd they are held to take another ~2 minutes.

The last two lines are one JSON object per kernel ({"kernels": [...]};
`launches` adds the counts of the main path's, the MPC path's, the
multi-device paths', the env paths', the camera path's, the eval's, the
LfP chain's and the gradient solvers' runs,
`launches_by_path` splits them), then
{"ok": true, "device": {...}}. There is no CPU mode: without a CUDA
card the script exits with code 2.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__" and not os.path.isdir(
        os.path.join(ROOT, "roboticsplayroompybullet_torch")):
    sys.exit("chip_smoke.py runs from a checkout of the repo: "
             "roboticsplayroompybullet_torch/ is not beside it")

import numpy as np  # noqa: E402
import torch  # noqa: E402
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"
SOURCE = "roboticsplayroompybullet_torch/csrc/fused_step.cu"
# the pl.pallas_call site of each TPU kernel the CUDA entry points replace
REPLACES = {"sim": "roboticsplayroompybullet_tpu/ops/fused_step.py:1271",
            "step": "roboticsplayroompybullet_tpu/ops/fused_step.py:1576",
            "rollout": "roboticsplayroompybullet_tpu/ops/fused_step.py:1706"}
POSITION_FIELDS = ("q", "obj_pos", "obj_quat", "art_q")
VELOCITY_FIELDS = ("qd", "obj_vel", "obj_angvel", "art_qd")
POS_MAX = 1e-4                      # position-like fields: max |Δ|
VEL_P99, VEL_MAX = 1e-3, 5e-2       # velocity fields: p99 and max |Δ|
ROLLOUT_MAX = 0.05                  # rollout ags max (test_fused.py:206-211)
MAX_FLIPS = 4                       # envs a step may leave the bounds above
MAX_STACK = 1024                    # bytes of stack frame a kernel may use
PEAK_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
PEAK_FLOPS64 = 34e12                # and float64 (NVIDIA's H100 data sheet)
PEAK_BYTES = 3.35e12                # H100 SXM HBM3 bytes/s
RESULTS = {}

# FLOPs of the kernel body's primitives, counted from csrc/fused_step.cu:
# an add, multiply, division, square root, sin or cos counts 1 (so an FMA
# counts 2); compares, selects, min/max and clips count 0.
QROT, QMUL, QNORM, QAXIS, CROSS, DOT, Q2M, M33V = 38, 28, 13, 6, 9, 5, 30, 15
M6V, BUILD_X = 72, 54
POINTS_OBOX = 3 + QROT + 3 + QROT + 30 + QROT + 3 + QROT     # 191
SPHERE_OBOX = 3 + QROT + 35 + QROT + 3 + QROT + 3            # 158


def say(*parts):
    print(*parts, flush=True)


def card():
    """The card's nvidia-smi name and power limit, for a result line."""
    return RESULTS["nvidia_smi"]


def record(key, value):
    RESULTS[key] = value
    return value


def device_phase():
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on the card",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    record("nvidia_smi", smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def ptxas_entries(log):
    """{entry: {registers, stack, spill_stores, spill_loads}} of the three
    __global__ entries, from nvcc -Xptxas -v."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(fs_\w+?)_kernel", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def build_phase():
    """Build the kernel from this checkout; every entry must keep its
    working set out of local memory: a stack frame of at most MAX_STACK
    bytes and nothing spilled."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    t0 = time.time()
    cuda_build.build(force=True)
    cuda_build.library()
    secs = time.time() - t0
    entries = ptxas_entries(cuda_build.BUILD_INFO.get("log", ""))
    say(f"[build] nvcc sm_90a: {secs:.1f} s, {cuda_build.launch_smem_bytes()}"
        " bytes of shared memory a block")
    bad = []
    for name in ("fs_sim", "fs_step", "fs_rollout"):
        e = entries.get(name, {})
        say(f"[build]   {name}: {e.get('registers')} registers, "
            f"{e.get('stack')} bytes stack frame, {e.get('spill_stores')} / "
            f"{e.get('spill_loads')} bytes spill stores / loads")
        if (len(e) < 4 or e["stack"] > MAX_STACK or e["spill_stores"]
                or e["spill_loads"]):
            bad.append(name)
    record("build_s", secs)
    record("ptxas", entries)
    if bad:
        raise AssertionError(f"{bad}: stack frame over {MAX_STACK} bytes, "
                             "spills, or no ptxas report")


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


def check_fields(tag, diffs):
    """Position-like max ≤ POS_MAX; velocity p99 ≤ VEL_P99, max ≤ VEL_MAX."""
    bad = []
    for name, (mx, p99) in diffs.items():
        if name in POSITION_FIELDS:
            ok = mx <= POS_MAX
            lim = f"max<={POS_MAX:g}"
        else:
            ok = p99 <= VEL_P99 and mx <= VEL_MAX
            lim = f"p99<={VEL_P99:g} max<={VEL_MAX:g}"
        say(f"[{tag}] {name:10s} max={mx:.3e} p99={p99:.3e} ({lim}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    record(tag, {k: {"max": v[0], "p99": v[1]} for k, v in diffs.items()})
    if bad:
        raise AssertionError(f"{tag}: {bad} outside the bounds")
    return max(v[0] for v in diffs.values())


def flagship_states(B, dev, seed):
    """The committed JAX batched_reset states of the flagship, tiled to B,
    with numpy-seeded velocity, servo-target and gripper noise."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch import interop
    d = tp.load("reset_UR5PlayAbsRPY1Obj")
    reps = -(-B // d["q"].shape[0])
    d = {k: np.concatenate([v] * reps)[:B] for k, v in d.items()}
    rs = np.random.RandomState(seed)
    d["qd"] = (rs.standard_normal(d["qd"].shape) * 0.3).astype(np.float32)
    d["grip"] = rs.uniform(0, 1, d["grip"].shape).astype(np.float32)
    d["ctrl_q"] = (d["ctrl_q"] + rs.uniform(-0.1, 0.1, d["ctrl_q"].shape)
                   ).astype(np.float32)
    return interop.state_from_numpy(d, dev)


def work(m, B, H, ik_iters=None, solve_iters=8):
    """(float32 FLOPs, float64 FLOPs, bytes) of each kernel's call on the
    main path's shapes: sim (B envs, 12 substeps), step (control + 12
    substeps) and rollout (H steps + ags), counted per phase from the
    source and this model's static row table, link types and ancestors
    (PERF.md §6 gives the per-phase formulas); control runs in float64.
    Each input byte is read once, each output byte written once."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    ik = fs.default_ik_iters(m.arm) if ik_iters is None else ik_iters
    v = cuda_build.model_values(*m, m.cfg.substeps, ik, solve_iters, False)
    n, na, no = v["n_dof"], v["n_arm"], v["n_obj"]
    rev, par = v["revolute"][:n], v["parent"][:n]
    ns, nb = v["n_static"], v["art_nb"]
    anc = [sum(v["pad_anc"][p * 7:p * 7 + na]) for p in range(4)]
    n_ee = sum(v["ee_anc"][:na])
    fk_pos = sum(QROT + 3 + QMUL + (QAXIS + QMUL + QNORM if r else 3 + QROT
                                    + 3) for r in rev)
    fk_vel = fk_pos + n * (3 + CROSS + 3 + QROT + 6)
    site = QROT + 3 + QMUL
    aba = sum((QAXIS + QMUL + Q2M if r else 3) + BUILD_X
              + (M6V if p >= 0 else 0) + 12 + 3 * CROSS + 3 + M6V
              + 3 * CROSS + 3                       # forward: v, c, pA
              + M6V + 24 + 4                        # U, D, u
              + (108 + 1 + M6V + 19 + BUILD_X + 432 + 468 + M6V + 6
                 if p >= 0 else 0)                  # Ia, pa, X^T Ia X
              + BUILD_X + M6V + 6 + 12 + 2 + 12     # accelerations
              for r, p in zip(rev, par))
    context = (4 * (QROT + 3 + QMUL + QROT + 3 + 3 + CROSS + 3)   # pads
               + no * (Q2M + 72) + v["n_grip"] * (QROT + 1) + 4 * 6
               + (QROT + 3 + CROSS) * sum(anc) + na + 15 * n + 60)
    rows = cuda_build.row_table(m.cfg, m.scene, v["pad_slot"])
    corner = 3 + QROT + 3
    geo = {cuda_build.ROW_FLOOR: lambda r: corner + 1,
           cuda_build.ROW_STATIC: lambda r: corner + ns * 36,
           cuda_build.ROW_ART: lambda r: corner + QAXIS
           + nb[r["k"]] * (QROT + 3 + POINTS_OBOX),
           cuda_build.ROW_PAD_BLOCK: lambda r: SPHERE_OBOX,
           cuda_build.ROW_BB: lambda r: corner + POINTS_OBOX,
           cuda_build.ROW_PAD_ART: lambda r: QAXIS
           + nb[r["k"]] * (QROT + 3 + SPHERE_OBOX),
           cuda_build.ROW_PAD_FLOOR: lambda r: 8,
           cuda_build.ROW_PAD_STATIC: lambda r: ns * 38}
    gather = sum(geo[r["kind"]](r) + 38 for r in rows)
    has = lambda r, key: r[key] >= 0  # noqa: E731
    kdir = sum(3 * (36 * has(r, "a") + 36 * has(r, "b") + 25 * has(r, "k")
                    + 9 * has(r, "g") + 9 * (anc[r["pj"]] if has(r, "pj")
                                             else 0)) for r in rows)
    accum = sum(18 * has(r, "a") + 18 * has(r, "b") + 19 * has(r, "k")
                + 6 * has(r, "g") + 6 * (anc[r["pj"]] if has(r, "pj") else 0)
                for r in rows)
    apply_ = no * 24 + 8 + 2 * v["n_grip"] + 2 * na + 6
    warm = sum(25 for _ in rows) + accum + apply_
    sweep = sum(50 + 15 * (has(r, "a") or has(r, "k")) + 15 * has(r, "b")
                + 12 * has(r, "k") + 6 * has(r, "g") + 3 * has(r, "vk") + 3
                + 6 * (anc[r["pj"]] if has(r, "pj") else 0)
                for r in rows) + accum + apply_
    integrate = 6 * n + no * (9 + 12 + QMUL + QNORM) + 16
    substep = (aba + fk_vel + context + gather + kdir + warm
               + solve_iters * sweep + integrate)
    ik_iter = (fk_pos + site + QMUL + 10 + (QROT + 3 + CROSS) * n_ee
               + 42 * n_ee + 6 + 12 * n_ee + 2 * na + 290 + 30 * n_ee)
    control = 2 * v["action_dim"] + fk_pos + site + 60 + ik * ik_iter + 4 * na
    _, nf = fs._field_rows(m.cfg, m.tree)
    _, ag = fs.ag_layout(m.cfg, m.tree)
    sim = v["n_sub"] * substep
    A, f4 = v["action_dim"], 4
    return {"sim": (B * sim, 0, f4 * B * (2 * nf + na + 1)),
            "step": (B * sim, B * control, f4 * B * (2 * nf + A)),
            "rollout": (B * H * (sim + 4), B * H * control,
                        f4 * B * (2 * nf + H * (A + ag)))}


def bound_ms(flops, flops64, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the float32 and float64 pipes (separate units) each at its peak."""
    t_ops = max(flops / PEAK_FLOPS, flops64 / PEAK_FLOPS64)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps, warm=True):
    """Mean device ms per call over `reps` calls, after one warm-up call
    unless `warm` is false."""
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def twin_phase(m, dev, built):
    """Kernel vs plain PyTorch twin on the card, per field, at the main
    path's batch (B=4096; the rollout at H=2). Returns each kernel's max
    error, the inputs, and the device ms of each plain call (the plain
    time timing_phase reports); holds the plain twin replayed from CUDA
    graphs equal to these eager calls. The plain calls come first, while
    the kernel builds beside them; built() waits for the build."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    cfg, tree = m.cfg, m.tree
    B = 4096
    st = flagship_states(B, dev, seed=1)
    X = fs.pack_state(cfg, tree, st)
    ctrl = st.ctrl_q.T.contiguous()
    grip = st.grip.contiguous()
    plain = {}

    def timed(name, fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        plain[name] = e0.elapsed_time(e1)
        return out

    rs = np.random.RandomState(2)
    H = 2
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (H, cfg.action_dim, B)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        p = timed("sim", lambda: fs.make_reference_sim(*m)(X, ctrl, grip))
        ps = timed("step", lambda: fs.make_reference_step(*m)(X, acts[0]))
        pr, pag = timed("rollout", lambda: fs.make_reference_rollout(
            *m, horizon=H)(X, acts))
        # the plain twin replayed from CUDA graphs, the later phases'
        # oracle, is this eager one bit for bit
        same = {"sim": torch.equal(plain_sim(*m)(X, ctrl, grip), p),
                "step": torch.equal(plain_step(*m)(X, acts[0]), ps),
                "rollout": all(map(torch.equal, plain_rollout(
                    *m, horizon=H)(X, acts), (pr, pag)))}
    say(f"[twin] the plain twin replayed from CUDA graphs == eager, bit "
        f"for bit: {same}")
    record("graphed_twin_equal", same)
    if not all(same.values()):
        raise AssertionError("the graphed plain twin is not the eager")

    built()
    with torch.no_grad():
        k = fs.make_cuda_sim(*m)(X, ctrl, grip)
        torch.cuda.synchronize()
        err = {"sim": check_fields(f"twin sim 12 substeps B={B}",
                                   field_diffs(cfg, tree, k, p))}
        step_k = fs.make_cuda_step(*m)
        ks = step_k(X, acts[0])
        err["step"] = check_fields(f"twin step B={B}",
                                   field_diffs(cfg, tree, ks, ps))
        kr, kag = fs.make_cuda_rollout(*m, horizon=H)(X, acts)
        e = check_fields(f"twin rollout H=2 B={B}",
                         field_diffs(cfg, tree, kr, pr))
        dag = (kag - pag).abs()
        say(f"[twin rollout H=2 B={B}] ags max={float(dag.max()):.3e} "
            f"p99={float(torch.quantile(dag.flatten(), 0.99)):.3e} "
            f"(max<={POS_MAX:g})")
        record("twin_rollout_ags_max", float(dag.max()))
        if float(dag.max()) > POS_MAX:
            raise AssertionError("rollout kernel ags differ from the plain")
        err["rollout"] = max(e, float(dag.max()))
        # whole-horizon kernel == H applications of the step kernel
        Xs = X
        for h in range(H):
            Xs = step_k(Xs, acts[h])
        torch.cuda.synchronize()
        d = float((kr - Xs).abs().max())
        say(f"[rollout == {H} x step kernel] max={d:.3e} (<=1e-5) "
            f"{'ok' if d <= 1e-5 else 'FAIL'}")
        record("rollout_vs_steps_max", d)
        if d > 1e-5:
            raise AssertionError("rollout kernel != repeated step kernel")
    return err, (X, ctrl, grip, acts), plain


def jax_parity_phase(dev):
    """The kernels on the fixtures' B=128 inputs vs the JAX outputs, at the
    bounds tests/test_torch_*.py hold the plain twin to."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import fused as F

    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    for env_id in (FLAGSHIP, "UR5Reach-v0", "pandaPick-v0", "pandaPlay-v0"):
        z = tp.load(f"sim3_{tp.key(env_id)}")
        m = core.build_model(CATALOG[env_id])
        X2 = fs.make_cuda_sim(*m, n_substeps=int(z["n_substeps"]))(
            T(z["X"]), T(z["ctrl"]), T(z["grip"])).cpu().numpy()
        worst = 0.0
        for name, sl in tp.field_slices(m.cfg, m.tree):
            d = float(np.abs(X2[sl] - z["X_out"][sl]).max())
            worst = max(worst, d)
            if d > 1e-4:
                raise AssertionError(f"JAX parity sim3 {env_id} {name}: {d}")
        say(f"[jax parity] sim 3 substeps {env_id}: max={worst:.3e} "
            "(per field <=1e-4) ok")
        record(f"jax_sim3_{env_id}", worst)

    m = core.build_model(CATALOG[FLAGSHIP])
    z = tp.load(f"step12_{tp.key(FLAGSHIP)}")
    X2 = fs.make_cuda_step(*m)(T(z["X"]), T(z["actions"])).cpu().numpy()
    sl = dict(tp.field_slices(m.cfg, m.tree))
    pos = max(float(np.abs(X2[sl[f]] - z["X_out"][sl[f]]).max())
              for f in ("q", "obj_pos", "obj_quat"))
    dqd = np.abs(X2[sl["qd"]] - z["X_out"][sl["qd"]])
    say(f"[jax parity] step 12 substeps: q/obj max={pos:.3e} (<=5e-4), qd "
        f"p99.9={np.quantile(dqd, 0.999):.3e} (<5e-4) "
        f"max={dqd.max():.3e} (<5e-3)")
    record("jax_step12", {"pos_max": pos, "qd_max": float(dqd.max())})
    if pos > 5e-4 or np.quantile(dqd, 0.999) >= 5e-4 or dqd.max() >= 5e-3:
        raise AssertionError("JAX parity step12 outside the bounds")

    for key in ("UR5PlayAbsRPY1Obj", "UR5Reach"):
        z = tp.load(f"rollout_{key}")
        m = core.build_model(CATALOG[key + "-v0"])
        st = interop.state_from_numpy(
            {k[3:]: v for k, v in z.items() if k.startswith("in_")}, dev)
        fin, rs_, ags = F.make_fused_rollout_whole(
            m, int(z["horizon"]), n_substeps=int(z["n_substeps"]))(
            st, T(z["actions"]))
        d = np.abs(ags.cpu().numpy() - z["ags"])
        dr = float(np.mean(np.abs(rs_.cpu().numpy() - z["rewards"])))
        dq = float(np.abs(fin.q.cpu().numpy() - z["out_q"]).max())
        say(f"[jax parity] rollout {key} H={int(z['horizon'])}: ags "
            f"p99={np.quantile(d, 0.99):.3e} (<1e-3) max={d.max():.3e} "
            f"(<0.05), reward mean|d|={dr:.3e} (<0.02), q max={dq:.3e} "
            "(<=5e-4)")
        record(f"jax_rollout_{key}", {"ags_max": float(d.max()),
                                      "reward_mean": dr, "q_max": dq})
        if (np.quantile(d, 0.99) >= 1e-3 or d.max() >= 0.05 or dr >= 0.02
                or dq > 5e-4):
            raise AssertionError(f"JAX parity rollout {key} outside bounds")


def main_path_inputs(m, dev):
    """The main path's states and actions: B=4096, H=40, actions
    uniform(-0.25, 0.25) from a numpy seed as in bench.py."""
    B, H = 4096, 40
    states = flagship_states(B, dev, seed=3)
    rs = np.random.RandomState(4)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (B, H, m.cfg.action_dim)),
                        dtype=torch.float32, device=dev)
    return states, acts


def main_path_phase(m, dev, states, acts):
    """make_fused_rollout_whole(m, 40) at B=4096, then the env step and one
    control interval of the sim kernel from the states' own servo targets
    (how bench.py drives make_pallas_sim), with the launch counts read
    around them."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import fused as F
    B, H = acts.shape[:2]
    roll = F.make_fused_rollout_whole(m, H)
    step = F.make_fused_batched_step(m)
    sim = fs.make_cuda_sim(*m)

    fs.reset_launch_counts()
    with torch.no_grad():
        fin, rew, ags = roll(states, acts)
        nxt = step(fin, acts[:, 0])
        settled = sim(fs.pack_state(m.cfg, m.tree, nxt),
                      nxt.ctrl_q.T.contiguous(), nxt.grip.contiguous())
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    say(f"[main path] launches {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the {k} kernel never launched")
    _, ag_dim = fs.ag_layout(m.cfg, m.tree)
    assert ags.shape == (B, H, ag_dim) and rew.shape == (B, H), (
        ags.shape, rew.shape)
    for name, t in (("ags", ags), ("rewards", rew), ("q", fin.q),
                    ("qd", fin.qd), ("obj_pos", fin.obj_pos),
                    ("obj_quat", fin.obj_quat), ("art_q", fin.art_q),
                    ("step q", nxt.q), ("sim X", settled)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path: non-finite {name}")
    if not bool((fin.t == states.t + H).all()):
        raise AssertionError("main path: t not advanced by H")
    qn = torch.linalg.vector_norm(fin.obj_quat, dim=-1)
    if float((qn - 1).abs().max()) > 1e-4:
        raise AssertionError("main path: block quaternions not unit")
    say(f"[main path] B={B} H={H}: finite, ags {tuple(ags.shape)}, "
        f"success rate {float((rew == 0).float().mean()):.4f}, block z "
        f"range [{float(fin.obj_pos[..., 2].min()):.3f}, "
        f"{float(fin.obj_pos[..., 2].max()):.3f}]")

    with torch.no_grad():
        ms = time_ms(lambda: roll(states, acts), reps=3)
    rps = B / (ms / 1e3)
    us = ms * 1e3 / H / (B / 1024)
    say(f"[main path] H={H} B={B}: {ms:.3f} ms per rollout call, "
        f"{rps:.1f} rollouts/s, {us:.1f} us per control step per 1024 envs")
    record("main_path", {"launches": launches, "ms": ms,
                         "rollouts_per_s": rps, "us_per_step_per_1024": us})
    return launches, (fin, rew, ags)


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
    (twin_phase holds that). A capture costs about one eager call of its
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


@contextlib.contextmanager
def plain_graphs():
    """While open, fs.make_reference_sim / _step / _rollout are plain_sim /
    _step / _rollout, for a path that builds its plain twin through them
    (the MPC step's reference backend)."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    made = (fs.make_reference_sim, fs.make_reference_step,
            fs.make_reference_rollout)
    fs.make_reference_sim, fs.make_reference_step = plain_sim, plain_step
    fs.make_reference_rollout = plain_rollout
    try:
        yield
    finally:
        (fs.make_reference_sim, fs.make_reference_step,
         fs.make_reference_rollout) = made


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


def horizon_twin_phase(m, dev, states, acts, kernel_out):
    """The rollout kernel at the main path's shape (B=4096, H=40).

    Free-running, two float32 roundings of this physics part ways: now and
    then a branch (IK fixed point, contact activation) flips in one env, and
    under random actions such differences grow until, by H=40, ~10% of envs
    differ by more than 1e-3 whichever two roundings are compared (the
    kernel built with and without FMA contraction does so too; PERF.md). So
    the kernel is held step by step, on the main path's inputs:
    - the rollout kernel equals H step-kernel launches, and its ags equal
      the plain ag of each step's state;
    - at every step the plain step from the kernel's own state agrees with
      the kernel's next state: each field's p99 within the one-step bounds,
      positions within ROLLOUT_MAX, and at most MAX_FLIPS envs outside the
      one-step bounds.
    The free-running plain rollout runs in the same plain calls (its envs
    beside the teacher-forced ones). Its rewards are held to the main
    path's (mean |diff| < 0.02, test_fused.py:206-211); its ags and final
    state are printed beside the kernel against itself from start states
    perturbed by a few ulps."""
    from roboticsplayroompybullet_torch.envs.rewards import compute_reward
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    cfg, tree = m.cfg, m.tree
    B, H = acts.shape[:2]
    tag = f"twin rollout H={H} B={B}"
    fin_k, rew_k, ags_k = kernel_out
    X0 = fs.pack_state(cfg, tree, states)
    a = acts.permute(1, 2, 0).contiguous()
    step_k = fs.make_cuda_step(*m)
    ag_of = fs.make_lane_ag(cfg, tree, m.arm)
    pos_rows = position_rows(cfg, tree, dev)
    bad, per_step = [], []
    with torch.no_grad():
        step_p = plain_step(*m)
        kr, kag = fs.make_cuda_rollout(*m, horizon=H)(X0, a)
        Xk, Xf, dag, ags_p = X0, X0, 0.0, []
        for h in range(H):
            Y = step_p(torch.cat([Xk, Xf], 1), torch.cat([a[h], a[h]], 1))
            Yt, Xf = Y[:, :B], Y[:, B:].contiguous()
            Xk = step_k(Xk, a[h])
            dag = max(dag, float((kag[h] - ag_of(Xk)).abs().max()))
            ags_p.append(ag_of(Xf))
            diffs, flips, pmax, over = judge_step(cfg, tree, pos_rows, Xk, Yt)
            if over or pmax >= ROLLOUT_MAX or flips > MAX_FLIPS:
                bad.append((h + 1, over, pmax, flips))
            per_step.append({"flips": flips, "fields": {
                k: {"max": v[0], "p99": v[1]} for k, v in diffs.items()}})
        torch.cuda.synchronize()
    worst = {k: (max(s["fields"][k]["max"] for s in per_step),
                 max(s["fields"][k]["p99"] for s in per_step))
             for k in per_step[0]["fields"]}
    for name, (mx, p99) in worst.items():
        lim = (f"p99<={POS_MAX:g} max<{ROLLOUT_MAX:g}"
               if name in POSITION_FIELDS else f"p99<={VEL_P99:g}")
        say(f"[{tag} teacher-forced] {name:10s} worst step: max={mx:.3e} "
            f"p99={p99:.3e} ({lim})")
    flips = [s["flips"] for s in per_step]
    say(f"[{tag} teacher-forced] envs outside the one-step bounds, per "
        f"step: max {max(flips)} (<={MAX_FLIPS}), {sum(flips)} env-steps of "
        f"{B * H} {'ok' if not bad else 'FAIL'}")
    dx = float((kr - Xk).abs().max())
    say(f"[rollout == {H} x step kernel] B={B}: state max={dx:.3e}, ags max="
        f"{dag:.3e} (<=1e-5){' bit-identical' if dx == 0 else ''} "
        f"{'ok' if dx <= 1e-5 and dag <= 1e-5 else 'FAIL'}")

    ags_p = torch.stack(ags_p).permute(2, 0, 1)          # (B, H, ag_dim)
    rew_p = compute_reward(cfg, ags_p, states.goal[:, None, :])
    dr = float((rew_k - rew_p).abs().mean())
    free = (ags_k - ags_p).abs()
    g = torch.Generator().manual_seed(0)
    Xe = X0 * (1 + 1e-6 * torch.randn(X0.shape, generator=g).to(dev))
    with torch.no_grad():
        _, kag_e = fs.make_cuda_rollout(*m, horizon=H)(Xe.contiguous(), a)
    base = (kag - kag_e).abs().permute(2, 0, 1)
    spread = {}
    for name, t in (("kernel vs plain", free),
                    ("kernel vs kernel, start x (1 + 1e-6 N(0,1))", base)):
        q = float(torch.quantile(t.flatten(), 0.99))
        frac = float((t[:, -1].amax(-1) > 1e-3).float().mean())
        spread[name] = {"ags_p99": q, "ags_max": float(t.max()),
                        "frac_envs_over_1e-3_at_H": frac}
        say(f"[{tag} free-running] {name}: ags p99={q:.3e} "
            f"max={float(t.max()):.3e}, envs >1e-3 at h={H}: {frac:.4f}")
    say(f"[{tag} free-running] reward mean|d|={dr:.3e} (<0.02) "
        f"{'ok' if dr < 0.02 else 'FAIL'}")
    final = field_diffs(cfg, tree, fs.pack_state(cfg, tree, fin_k), Xf)
    say(f"[{tag} free-running] final state max/p99: " + ", ".join(
        f"{k} {v[0]:.2e}/{v[1]:.2e}" for k, v in final.items()))
    record(tag, {"teacher_forced": per_step, "rollout_vs_steps":
                 {"state_max": dx, "ags_max": dag}, "free_running": spread,
                 "reward_mean": dr, "final": {
                     k: {"max": v[0], "p99": v[1]} for k, v in final.items()}})
    if bad:
        raise AssertionError(f"{tag}: steps outside the bounds "
                             f"(step, fields, position max, flips): {bad}")
    if dx > 1e-5 or dag > 1e-5:
        raise AssertionError(f"rollout kernel != {H} step-kernel launches")
    if dr >= 0.02:
        raise AssertionError(f"{tag}: rewards differ from the plain twin's")


def timing_phase(m, dev, inputs, plain_first):
    """Each kernel at B=4096 (rollout at H=2) on the twin phase's inputs,
    twice, beside its plain version's eager call there (one cold call: the
    plain twin is host-bound, ~10^4 times the kernel, and its first call
    costs what a later one does); the rollout kernel's batch scaling at
    H=40 and its split into Jacobi sweeps / IK / the rest."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    B, H = 4096, 2
    X, ctrl, grip, acts = inputs
    rs = np.random.RandomState(6)
    kernels = {
        "sim": lambda f=fs.make_cuda_sim(*m): f(X, ctrl, grip),
        "step": lambda f=fs.make_cuda_step(*m): f(X, acts[0]),
        "rollout": lambda f=fs.make_cuda_rollout(*m, horizon=H): f(X, acts),
    }
    out = {}
    with torch.no_grad():
        for name, kern in kernels.items():
            k1 = time_ms(kern, 3)
            k2 = time_ms(kern, 3)
            out[name] = ((k1 + k2) / 2, plain_first[name])
            say(f"[timing] {name} B={B}{' H=2' if name == 'rollout' else ''}"
                f": kernel {out[name][0]:.3f} ms ({k1:.3f}, {k2:.3f}), "
                f"plain {out[name][1]:.1f} ms")
    record("timing_ms", {k: {"kernel": v[0], "plain": v[1]}
                         for k, v in out.items()})

    # how the whole-horizon kernel scales with the batch (one warp per env:
    # at 8 resident warps an SM, one wave holds 1056 envs)
    H = 40
    scaling = {}
    with torch.no_grad():
        for Bs in (1024, 4096, 16384):
            st = flagship_states(Bs, dev, seed=7)
            Xs = fs.pack_state(m.cfg, m.tree, st)
            a = torch.tensor(rs.uniform(-0.25, 0.25,
                                        (H, m.cfg.action_dim, Bs)),
                             dtype=torch.float32, device=dev)
            roll = fs.make_cuda_rollout(*m, horizon=H)
            ms = time_ms(lambda: roll(Xs, a), 2)
            scaling[Bs] = Bs / (ms / 1e3)
            say(f"[scaling] rollout kernel H={H} B={Bs}: {ms:.3f} ms, "
                f"{scaling[Bs]:.1f} rollouts/s")
    record("scaling_rollouts_per_s", scaling)

    # where the rollout's time goes: the same call at solve_iters=0 and
    # ik_iters=0 beside the full one (tools/time_fused_kernel.py)
    import time_fused_kernel as tfk
    X, acts = tfk.flagship_inputs(m, 4096, H, dev)
    sp = tfk.phase_split(m, H, cuda_build.SOURCE, X, acts)
    say(f"[split] rollout kernel H={H} B=4096: full {sp['full']:.3f} ms, "
        f"solve_iters=0 {sp['no_sweeps']:.3f} ms, ik_iters=0 "
        f"{sp['no_ik']:.3f} ms -> Jacobi sweeps {sp['sweeps']:.3f}, IK "
        f"{sp['ik']:.3f}, rest {sp['rest']:.3f}")
    record("split", sp)
    return out


# ---------------------------------------------------------------------------
# the MPC slice (solver/mpc.py)
# ---------------------------------------------------------------------------

# the fused replan of bench.py:270-283 and the eval control step at the
# tools/eval_mpc.py defaults (4 envs, sigma 0.3)
PLAN_CFG = dict(horizon=10, pop=1024, iters=2, algorithm="mppi")
EVAL_ENVS, EVAL_SIGMA = 4, 0.3
CHAIN = 10                          # sequential replans timed in one chain
REACH_ENVS, REACH_STEPS, REACH_SHRINK = 3, 20, 0.75  # test_solver.py:75-91
# the closed loop refines by CEM: its elite sigma shrinks as the EE nears
# the goal, where MPPI keeps sigma_init and its mean jitters by about that
# much (the port's loop is JAX's on the same draws: test_torch_mpc.py)
REACH_CFG = dict(PLAN_CFG, algorithm="cem")
PLAN_P99, PLAN_MAX = 1e-3, 5e-2     # plan means (tests/test_torch_mpc.py)



def preview_phase(dev):
    """The planners' preview model (ik 8 / solve 8 iterations, with_ee)
    through the rollout kernel against the plain twin, per field at the
    twin bounds and the ags (ee tail included) within POS_MAX, at B=1024,
    H=2 on the flagship and the 2-block pandaPlay. The actions are what the
    preview sees in a replan: candidates drawn by the planner's sampler
    (sigma 0.3) about a plan that holds each env's pose. Then, printed and
    recorded but not held: pandaPlay under uniform(-0.25, 0.25) actions
    (absolute targets about the origin, random orientations), the kernel
    against the plain twin beside the plain twin in float64 against itself
    in float32 on the same inputs."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.solver import mpc
    cfg = mpc.MPCConfig(horizon=2, sigma_init=EVAL_SIGMA)
    kw = dict(horizon=cfg.horizon, ik_iters=cfg.preview_ik_iters,
              solve_iters=cfg.preview_solve_iters, with_ee=True)
    B = 1024
    for env_id in (FLAGSHIP, "pandaPlay-v0"):
        m = core.build_model(CATALOG[env_id])
        if env_id == FLAGSHIP:
            st = flagship_states(B, dev, seed=8)
        else:
            X0 = tp.load(f"sim3_{tp.key(env_id)}")["X"]
            X0 = torch.tensor(np.tile(X0, (1, -(-B // X0.shape[1])))[:, :B],
                              device=dev)
            st = fs.unpack_state(m.cfg, m.tree, X0,
                                 tp.zero_state(m.cfg, m.tree, B, dev))
        X = fs.pack_state(m.cfg, m.tree, st)
        g = torch.Generator(device=dev).manual_seed(9)
        high = torch.tensor(m.cfg.action_high, device=dev)
        acts = mpc._sample(g, mpc.init_plan_from_state(m, cfg, st), cfg, 1,
                           high)[:, 0].permute(1, 2, 0).contiguous()
        with torch.no_grad():
            kr, kag = fs.make_cuda_rollout(*m, **kw)(X, acts)
            pr, pag = plain_rollout(*m, **kw)(X, acts)
        torch.cuda.synchronize()
        tag = (f"preview {env_id} H=2 B={B} ik {kw['ik_iters']} solve "
               f"{kw['solve_iters']} with_ee")
        check_fields(tag, field_diffs(m.cfg, m.tree, kr, pr))
        _, ag_dim = fs.ag_layout(m.cfg, m.tree, with_ee=True)
        dag = float((kag - pag).abs().max())
        ee = float((kag[:, -3:] - pag[:, -3:]).abs().max())
        say(f"[{tag}] ags {tuple(kag.shape)} max={dag:.3e}, ee tail max="
            f"{ee:.3e} (<={POS_MAX:g}); {card()}")
        record(f"{tag} ags", {"max": dag, "ee_max": ee})
        if kag.shape != (2, ag_dim, B) or dag > POS_MAX:
            raise AssertionError(f"{tag}: ags differ from the plain twin's")

    rs = np.random.RandomState(19)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (2, m.cfg.action_dim, B)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        kr, _ = fs.make_cuda_rollout(*m, **kw)(X, acts)
        ref = plain_rollout(*m, **kw)
        p32, _ = ref(X, acts)
        p64, _ = ref(X.double(), acts.double())
    torch.cuda.synchronize()
    tag = f"preview pandaPlay-v0 H=2 B={B} uniform actions, not held"
    row = {}
    for name, (a, b) in (("kernel vs plain", (kr, p32)),
                          ("plain f64 vs plain f32", (p64, p32)),
                          ("kernel vs plain f64", (kr, p64))):
        d = field_diffs(m.cfg, m.tree, a, b)
        row[name] = {k: {"max": v[0], "p99": v[1]} for k, v in d.items()}
        say(f"[{tag}] {name}: max " + ", ".join(
            f"{k} {v[0]:.3e}" for k, v in d.items()) + f"; {card()}")
    record(tag, row)


def _mpc_compare(tag, m, got, want):
    """The MPC step's bounds: each state field max <= 1e-4, plan means
    p99 <= PLAN_P99 and max <= PLAN_MAX, sigmas equal, t advanced."""
    st, pl = got[0], got[1]
    fields = {f: float((getattr(st, f) - want[f]).abs().max())
              for f in POSITION_FIELDS + VELOCITY_FIELDS}
    d = (pl.mean - want["mean"]).abs().flatten()
    p99, mx = float(torch.quantile(d, 0.99)), float(d.max())
    say(f"[{tag}] states max " + ", ".join(
        f"{k} {v:.2e}" for k, v in fields.items()) + f" (<={POS_MAX:g}); "
        f"plan means p99={p99:.3e} (<={PLAN_P99:g}) max={mx:.3e} "
        f"(<={PLAN_MAX:g}); {card()}")
    record(tag, {"states_max": fields, "plan_p99": p99, "plan_max": mx})
    if (max(fields.values()) > POS_MAX or p99 > PLAN_P99 or mx > PLAN_MAX
            or not torch.equal(pl.sigma, want["sigma"])
            or not torch.equal(st.t, want["t"])):
        raise AssertionError(f"{tag}: outside the bounds")


def mpc_twin_phase(dev):
    """make_batched_fused_mpc_step through the kernels against the plain
    twin on the card from the same generator seed (2 envs x 64, H=3, one
    iteration, full model, with_ee and the fixture's cost_fn), then through
    the kernels against the JAX step of tests/torch_fixtures (its normals,
    1 substep)."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.solver import mpc
    m = core.build_model(CATALOG[FLAGSHIP])
    cfg = mpc.MPCConfig(horizon=3, pop=64, iters=1, algorithm="mppi",
                        sigma_init=EVAL_SIGMA)
    st = flagship_states(2, dev, seed=10)
    plans = mpc.init_batched_plan(m, cfg, 2, st)
    params = {"reach": torch.tensor([0.5, 1.0], device=dev)}
    out = {}
    with torch.no_grad(), plain_graphs():
        for backend in ("cuda", "reference"):
            step = mpc.make_batched_fused_mpc_step(
                m, cfg, 2, backend=backend, with_ee=True,
                cost_fn=tp.mpc_step_cost(m.cfg, cfg.weights))
            g = torch.Generator(device=dev).manual_seed(11)
            out[backend] = step(st, plans, g, params)
    torch.cuda.synchronize()
    ref_st, ref_pl = out["reference"][:2]
    want = {f: getattr(ref_st, f) for f in POSITION_FIELDS + VELOCITY_FIELDS}
    want.update(mean=ref_pl.mean, sigma=ref_pl.sigma, t=ref_st.t)
    _mpc_compare("mpc step cuda vs reference, 2x64 H=3", m, out["cuda"],
                 want)

    z = tp.load(f"mpc_step_{tp.key(FLAGSHIP)}")
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]), pop=int(z["pop"]),
                        iters=int(z["iters"]), algorithm="mppi",
                        sigma_init=float(z["sigma_init"]))
    normals = iter(torch.tensor(z["normals"], device=dev))
    draw = mpc._normals
    mpc._normals = lambda gen, shape, device: next(normals).reshape(shape)
    try:
        st = interop.state_from_numpy(
            {k[3:]: v for k, v in z.items() if k.startswith("in_")}, dev)
        step = mpc.make_batched_fused_mpc_step(
            m, cfg, int(z["n_envs"]), backend="cuda",
            n_substeps=int(z["n_substeps"]), with_ee=True,
            cost_fn=tp.mpc_step_cost(m.cfg, cfg.weights))
        with torch.no_grad():
            got = step(st, mpc.PlanState(
                torch.tensor(z["plan_mean"], device=dev),
                torch.tensor(z["plan_sigma"], device=dev)),
                torch.Generator(device=dev),
                {"reach": torch.tensor(z["reach"], device=dev)})
        torch.cuda.synchronize()
    finally:
        mpc._normals = draw
    want = {f: torch.tensor(z[f"out_{f}"], device=dev)
            for f in POSITION_FIELDS + VELOCITY_FIELDS + ("t",)}
    want.update(mean=torch.tensor(z["out_mean"], device=dev),
                sigma=torch.tensor(z["out_sigma"], device=dev))
    _mpc_compare("mpc step kernels vs JAX fixture, 2x64 H=2", m, got, want)


@contextlib.contextmanager
def first_calls():
    """While open, each wrapper that fs.make_cuda_step / make_cuda_rollout
    / make_cuda_sim makes passes its calls through unchanged (the launch
    counts are its own) and keeps its first call: yields the list of
    {entry, m, args, kw, inputs} it appends to, one per wrapper, in the
    order of first calls."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    log = []
    made = (fs.make_cuda_step, fs.make_cuda_rollout, fs.make_cuda_sim)

    def keep(entry, make):
        def mk(cfg, tree, arm, scene, *args, **kw):
            f, first = make(cfg, tree, arm, scene, *args, **kw), []

            def call(*xs):
                if not first:
                    first.append(True)
                    log.append(dict(entry=entry, m=(cfg, tree, arm, scene),
                                    args=args, kw=kw,
                                    inputs=[x.clone() for x in xs]))
                return f(*xs)
            return call
        return mk

    fs.make_cuda_step = keep("step", made[0])
    fs.make_cuda_rollout = keep("rollout", made[1])
    fs.make_cuda_sim = keep("sim", made[2])
    try:
        yield log
    finally:
        fs.make_cuda_step, fs.make_cuda_rollout, fs.make_cuda_sim = made


def preview_horizon_check(m, kw, parts, plain_steps=None):
    """parts: [(tag, X0 (NF, B), actions (H, A, B), with_ee)] of one model at
    one fidelity kw (n_substeps, ik_iters, solve_iters), each through the
    rollout kernel and held step by step as horizon_twin_phase holds the
    H=40 rollout: the rollout kernel equals H step-kernel launches of the
    same fidelity (state and ags, the latter against the plain ag of each
    step's state, within 1e-5), and at every step (the first plain_steps
    when given) the plain step from the kernel's state agrees with the
    kernel's next state (each field's p99
    within the one-step bounds, positions within ROLLOUT_MAX). An env
    outside the one-step bounds is stepped again by the plain twin in
    float64, and counts against the kernel only where the kernel is
    farther from that step than the float32 plain step is (env_error): at
    most MAX_FLIPS such envs a part and step. An env whose position moved
    ROLLOUT_MAX or more from the plain step (a branch of the physics, such
    as a block pinched between the pads) must pass `jump_witness`: the
    kernel's outcome is reached by the float64 plain step from inputs
    within a few float32 roundings about as often as the float32 plain
    step's own outcome is, and outcomes planted a position jump away are
    not. A population is a few start
    states times many candidates, so an env near a branch (contact,
    clamp) brings its candidates with it. The plain steps of all parts run
    as one call a step."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    cfg, tree = m.cfg, m.tree
    step_k = fs.make_cuda_step(*m, **kw)
    step_p = plain_step(*m, **kw)
    pos_rows = position_rows(cfg, tree, parts[0][1].device)
    H = parts[0][2].shape[0]
    Bs = [X.shape[1] for _, X, _, _ in parts]
    ag_of = [fs.make_lane_ag(cfg, tree, m.arm, ee) for *_, ee in parts]
    worst = [dict(flips=0, against=0, ags=0.0, fields={}) for _ in parts]
    bad, outside, jumps = [], [], []
    with torch.no_grad():
        runs = [fs.make_cuda_rollout(*m, H, with_ee=ee, **kw)(X, a)
                for _, X, a, ee in parts]
        Xk = [X for _, X, _, _ in parts]
        for h in range(H):
            Xin = list(Xk)
            if plain_steps is not None and h >= plain_steps:
                for j, (_, _, a, _) in enumerate(parts):
                    Xk[j] = step_k(Xin[j], a[h])
                    worst[j]["ags"] = max(worst[j]["ags"], float(
                        (runs[j][1][h] - ag_of[j](Xk[j])).abs().max()))
                continue
            Y = torch.split(step_p(torch.cat(Xin, 1), torch.cat(
                [a[h] for _, _, a, _ in parts], 1)), Bs, 1)
            flagged = []
            for j, (tag, _, a, _) in enumerate(parts):
                Xk[j] = step_k(Xin[j], a[h])
                w = worst[j]
                w["ags"] = max(w["ags"], float(
                    (runs[j][1][h] - ag_of[j](Xk[j])).abs().max()))
                diffs, flips, pmax, over = judge_step(cfg, tree, pos_rows,
                                                      Xk[j], Y[j])
                w["flips"] = max(w["flips"], flips)
                for k, (mx, p99) in diffs.items():
                    o = w["fields"].get(k, (0.0, 0.0))
                    w["fields"][k] = (max(o[0], mx), max(o[1], p99))
                if over:
                    bad.append((tag, h + 1, over, pmax))
                if pmax >= ROLLOUT_MAX:
                    jump = torch.nonzero(((Xk[j] - Y[j]).abs() * pos_rows[
                        :, None]).amax(0) >= ROLLOUT_MAX).flatten()
                    o = jump_witness(step_p, Xin[j][:, jump], a[h][:, jump],
                                     Xk[j][:, jump], Y[j][:, jump], pos_rows)
                    jumps.append({"part": tag, "step": h + 1,
                                  "envs": jump.tolist(), "max": pmax, **o})
                    if not all(o["ok"]):
                        bad.append((tag, h + 1, "position jump not "
                                    "witnessed", jump.tolist(), o))
                flagged.append(torch.nonzero(
                    env_error(Xk[j], Y[j], pos_rows) > 1).flatten())
            if sum(len(f) for f in flagged):
                cat = lambda xs: torch.cat(  # noqa: E731
                    [x[:, f] for x, f in zip(xs, flagged)], 1)
                Y64 = padded(step_p, cat(Xin).double(), cat(
                    [a[h] for _, _, a, _ in parts]).double())
                e_k = env_error(cat(Xk), Y64, pos_rows)
                e_p = env_error(cat(Y), Y64, pos_rows)
                n0 = 0
                for j, f in enumerate(flagged):
                    ek, ep = e_k[n0:n0 + len(f)], e_p[n0:n0 + len(f)]
                    n0 += len(f)
                    n = int((ek > ep).sum())
                    worst[j]["against"] = max(worst[j]["against"], n)
                    if len(f):
                        outside.append({
                            "part": parts[j][0], "step": h + 1,
                            "envs": f.tolist(),
                            "kernel_vs_plain": env_error(
                                Xk[j][:, f], Y[j][:, f], pos_rows).tolist(),
                            "kernel_vs_f64": ek.tolist(),
                            "plain_vs_f64": ep.tolist()})
                    if n > MAX_FLIPS:
                        bad.append((parts[j][0], h + 1, n))
        torch.cuda.synchronize()
    for o in jumps:
        say(f"[{o['part']} teacher-forced] step {o['step']}: envs whose "
            f"position moved >= {ROLLOUT_MAX:g} from the plain step (max "
            f"{o['max']:.3e}); of {JUMP_COPIES} float64 plain steps from "
            "inputs within rounding, how many reach (env: the kernel's "
            "outcome, the float32 plain step's, the kernel's + ROLLOUT_MAX, "
            "their midpoint; needed for the kernel's): " + ", ".join(
                f"{e}: {k} {p} {f1} {f2}; {n} {'ok' if ok else 'FAIL'}"
                for e, k, p, f1, f2, n, ok in zip(
                    o["envs"], o["kernel"], o["plain"], o["planted_over"],
                    o["planted_mid"], o["needed"], o["ok"])))
    for o in outside:
        say(f"[{o['part']} teacher-forced] step {o['step']}: envs outside "
            "the one-step bounds (env: kernel vs plain, kernel vs float64, "
            "plain vs float64, in units of the bounds) " + ", ".join(
                f"{e}: {a:.2f} {b:.2f} {c:.2f}" for e, a, b, c in zip(
                    o["envs"], o["kernel_vs_plain"], o["kernel_vs_f64"],
                    o["plain_vs_f64"])))
    fails = []
    for j, (tag, X, a, _) in enumerate(parts):
        w = worst[j]
        w["state"] = float((runs[j][0] - Xk[j]).abs().max())
        f = w["fields"]
        say(f"[{tag} teacher-forced] worst step: position max " + ", ".join(
            f"{k} {f[k][0]:.2e}" for k in f if k in POSITION_FIELDS)
            + f" (<{ROLLOUT_MAX:g}); p99 " + ", ".join(
            f"{k} {v[1]:.2e}" for k, v in f.items())
            + f" (positions <={POS_MAX:g}, velocities <={VEL_P99:g}); envs "
            f"outside the one-step bounds max {w['flips']}, of them farther "
            f"from the float64 step than the plain twin max {w['against']} "
            f"(<={MAX_FLIPS}); rollout == {H} x step kernel: state max="
            f"{w['state']:.3e}, ags max={w['ags']:.3e} (<=1e-5); {card()}")
        record(f"{tag} teacher-forced", {
            "fields": {k: {"max": v[0], "p99": v[1]} for k, v in f.items()},
            "flips_max": w["flips"], "against_kernel_max": w["against"],
            "outside": [o for o in outside if o["part"] == tag],
            "jumps": [o for o in jumps if o["part"] == tag],
            "rollout_vs_steps": {"state_max": w["state"],
                                 "ags_max": w["ags"]}})
        if w["state"] > 1e-5 or w["ags"] > 1e-5:
            fails.append(f"{tag}: rollout kernel != {H} step-kernel launches")
    if bad:
        fails.append("steps outside the bounds (tag, step, fields, position"
                     f" max) or (tag, step, envs against the kernel): {bad}")
    if fails:
        raise AssertionError("; ".join(fails))


JUMP_COPIES, JUMP_NOISE, JUMP_FLOOR = 256, 3e-7, 16


def jump_witness(step_p, x, a, xk, y, pos_rows):
    """Whether the kernel's step xk is a branch of the physics, for the n
    envs (columns) of x and a whose kernel step jumped from the float32
    plain step y. The plain step runs in float64 from JUMP_COPIES copies of
    each env's input, each row scaled by 1 + JUMP_NOISE * N(0, 1) (a few
    float32 roundings), and counts the copies that land within the
    one-step bounds of: the kernel's outcome; the float32 plain step's
    (the reference's own rounding, the calibration); and two planted
    faults of the size a jump is flagged at, the kernel's outcome moved
    ROLLOUT_MAX further along the jump and the midpoint of the two
    outcomes. The kernel's outcome passes if its count reaches the plain
    step's, capped at JUMP_FLOOR (1/16 of the copies; at least 1): a wrong
    outcome reached 1 time in 256 fails unless the reference's own
    outcome is as rare. Each planted fault must count under the kernel's
    need, or the witness cannot tell a fault at this branch and the jump
    fails. Returns the counts a list each, and ok."""
    n, k = x.shape[1], JUMP_COPIES
    g = torch.Generator(device=x.device).manual_seed(34)
    noise = 1 + JUMP_NOISE * torch.randn(
        (x.shape[0], n * k), generator=g, device=x.device,
        dtype=torch.float64)
    y64 = padded(step_p, x.double().repeat_interleave(k, 1) * noise,
                 a.double().repeat_interleave(k, 1))
    xk, y = xk.double(), y.double()
    d = (xk - y) * pos_rows[:, None]
    over = xk + ROLLOUT_MAX * d / d.abs().amax(0, keepdim=True)
    counts = {}
    for name, t in (("kernel", xk), ("plain", y), ("planted_over", over),
                    ("planted_mid", (xk + y) / 2)):
        err = env_error(y64, t.repeat_interleave(k, 1), pos_rows)
        counts[name] = (err.reshape(n, k) <= 1).sum(1)
    need = counts["plain"].clamp(1, JUMP_FLOOR)
    ok = ((counts["kernel"] >= need) & (counts["planted_over"] < need)
          & (counts["planted_mid"] < need))
    return {**{c: v.tolist() for c, v in counts.items()},
            "needed": need.tolist(), "ok": ok.tolist()}


def mpc_shapes_phase(calls, plain_steps=None):
    """The MPC path's kernels held at the path's own shapes, on its own
    inputs (the first call of each kernel wrapper in mpc_path_phase,
    `calls` {piece: first_calls log}): the preview rollouts (H=10, ik 8 /
    solve 8: the flagship replan's B=1024 and the eval step's B=4096
    with_ee in one plain call a step, the UR5Reach closed loop's B=1024)
    by preview_horizon_check (teacher-forced over the first plain_steps
    when given), and the executed steps (the eval step's B=4, the closed
    loop's B=1) against the plain step at the twin bounds."""
    from roboticsplayroompybullet_torch.envs.core import EnvModel
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    fid = ("n_substeps", "ik_iters", "solve_iters")
    groups = {}
    for piece, log in calls.items():
        for c in log:
            X, a = c["inputs"]
            kw = {k: c["kw"].get(k) for k in fid if k in c["kw"]}
            tag = (f"mpc path {piece} {c['entry']} kernel B={X.shape[1]}"
                   + (f" H={a.shape[0]} ik {kw.get('ik_iters') or 'default'}"
                      f" solve {kw.get('solve_iters') or 8}"
                      + (" with_ee" if c["kw"].get("with_ee") else "")
                      if c["entry"] == "rollout" else ""))
            if c["entry"] == "step":
                with torch.no_grad():
                    k = fs.make_cuda_step(*c["m"], **kw)(X, a)
                    p = plain_step(*c["m"], **kw)(X, a)
                torch.cuda.synchronize()
                check_fields(tag, field_diffs(c["m"][0], c["m"][1], k, p))
                say(f"[{tag}] {card()}")
                continue
            key = (id(c["m"][0]), tuple(sorted(kw.items())))
            groups.setdefault(key, (c["m"], kw, []))[2].append(
                (tag, X, a, bool(c["kw"].get("with_ee"))))
    for m, kw, parts in groups.values():
        preview_horizon_check(EnvModel(*m), kw, parts, plain_steps)


def mpc_path_inputs(dev):
    """Models, configs, start states and plans of the MPC path: the
    flagship replan and eval step, the UR5Reach closed loop from the reach
    fixture's start states."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.solver import mpc
    m = core.build_model(CATALOG[FLAGSHIP])
    plan_cfg = mpc.MPCConfig(**PLAN_CFG)
    eval_cfg = mpc.MPCConfig(**PLAN_CFG)._replace(sigma_init=EVAL_SIGMA)
    one = flagship_states(1, dev, seed=12)
    envs = flagship_states(EVAL_ENVS, dev, seed=13)
    z = tp.load("rollout_UR5Reach")
    reach = interop.state_from_numpy(
        {k[3:]: v[:REACH_ENVS] for k, v in z.items()
         if k.startswith("in_")}, dev)
    return dict(m=m, plan_cfg=plan_cfg, eval_cfg=eval_cfg, one=one,
                plan0=mpc.PlanState(*(x[0] for x in mpc.init_batched_plan(
                    m, plan_cfg, 1, one))),
                envs=envs, plans=mpc.init_batched_plan(m, eval_cfg,
                                                       EVAL_ENVS, envs),
                params={"reach": torch.full((EVAL_ENVS,), 0.5, device=dev)},
                m_reach=core.build_model(CATALOG["UR5Reach-v0"]),
                reach_cfg=mpc.MPCConfig(**REACH_CFG), reach=reach)


def mpc_path_phase(dev, p):
    """The MPC path, with the launch counts read around it: one flagship
    replan (make_fused_planner, PLAN_CFG), one eval control step (4 envs x
    1024 candidates) and the UR5Reach closed loop (make_fused_mpc_rollout
    from init_plan's zero mean, REACH_CFG: 1024 candidates, H=10, 2 CEM
    iterations, 20 steps) from each of the first REACH_ENVS start states,
    each of which must end below REACH_SHRINK of its start EE-goal
    distance. Returns the counts and the first call of each kernel
    wrapper of each piece (first_calls) for mpc_shapes_phase. After the
    counts are read, the same loops by MPPI (PLAN_CFG, JAX's default) are
    printed beside them, not held to the bar: the port's loop is JAX's
    function of the draws (tests/test_torch_mpc.py::
    test_closed_loop_matches_jax), so this is how JAX's MPPI fares too."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.envs.obs import achieved_goal
    from roboticsplayroompybullet_torch.envs.state import EnvState
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.solver import cost, mpc
    m, mr, cfg = p["m"], p["m_reach"], p["plan_cfg"]
    planner = mpc.make_fused_planner(m, cfg)
    step = mpc.make_batched_fused_mpc_step(
        m, p["eval_cfg"], EVAL_ENVS, with_ee=True,
        cost_fn=tp.mpc_step_cost(m.cfg, p["eval_cfg"].weights))
    run = mpc.make_fused_mpc_rollout(mr, p["reach_cfg"], REACH_STEPS)
    dist = lambda s: cost.goal_distance(  # noqa: E731
        mr.cfg, achieved_goal(mr.cfg, mr.tree, mr.arm, s), s.goal)
    starts = [EnvState(**{k: v[i:i + 1] for k, v in vars(p["reach"]).items()})
              for i in range(REACH_ENVS)]
    calls = {}
    fs.reset_launch_counts()
    with torch.no_grad():
        with first_calls() as calls["replan"]:
            pl1, best1 = planner(p["one"], p["plan0"],
                                 torch.Generator(device=dev).manual_seed(14))
        with first_calls() as calls["eval"]:
            st2, pl2, rs, ags = step(
                p["envs"], p["plans"],
                torch.Generator(device=dev).manual_seed(14), p["params"])
        loops = []
        with first_calls() as calls["closed loop"]:
            for i, s0 in enumerate(starts):
                fin, acts, rws, bests = run(
                    s0, torch.Generator(device=dev).manual_seed(15 + i))
                loops.append((fin, acts, bests))
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    say(f"[mpc path] launches {launches}")
    for k in ("rollout", "step"):
        if launches[k] < 1:
            raise AssertionError(f"the {k} kernel never launched")
    A = m.cfg.action_dim
    high = torch.tensor(m.cfg.action_high, device=dev)
    if (pl1.mean.shape != (cfg.horizon, A) or best1.shape != ()
            or not bool(torch.isfinite(pl1.mean).all())
            or not bool((pl1.mean.abs() <= high).all())):
        raise AssertionError("mpc replan: wrong shapes, non-finite or "
                             "outside the action bounds")
    if (st2.q.shape != p["envs"].q.shape or pl2.mean.shape != (
            EVAL_ENVS, cfg.horizon, A) or rs.shape != (EVAL_ENVS,)
            or not all(bool(torch.isfinite(t).all())
                       for t in (st2.q, st2.obj_pos, pl2.mean, ags))
            or not bool((st2.t == p["envs"].t + 1).all())):
        raise AssertionError("mpc eval step: wrong shapes, t or non-finite")
    if not bool((pl2.mean.abs() <= high).all()):
        raise AssertionError("mpc eval step: plan outside the action bounds")
    res = []
    for i, (s0, (fin, acts, bests)) in enumerate(zip(starts, loops)):
        d0, d1 = float(dist(s0)[0]), float(dist(fin)[0])
        ok = (d1 < REACH_SHRINK * d0 and bool(torch.isfinite(bests).all())
              and acts.shape == (REACH_STEPS, mr.cfg.action_dim))
        say(f"[mpc closed loop] UR5Reach env {i}, CEM from the zero mean: "
            f"EE-goal distance {d0:.4f} -> {d1:.4f} m in {REACH_STEPS} "
            f"steps, ratio {d1 / d0:.3f} (<{REACH_SHRINK:g}) "
            f"{'ok' if ok else 'FAIL'}; {card()}")
        res.append({"d0": d0, "d1": d1})
        if not ok:
            raise AssertionError(f"closed loop env {i}: {d0} -> {d1}")
    mppi = mpc.make_fused_mpc_rollout(mr, cfg, REACH_STEPS)
    for i, s0 in enumerate(starts):
        with torch.no_grad():
            fin = mppi(s0, torch.Generator(device=dev).manual_seed(15 + i))[0]
        d0, d1 = float(dist(s0)[0]), float(dist(fin)[0])
        say(f"[mpc closed loop] UR5Reach env {i}, MPPI from the zero mean: "
            f"{d0:.4f} -> {d1:.4f} m, ratio {d1 / d0:.3f} (not held to the "
            "bar)")
        res[i]["mppi_d1"] = d1
    record("mpc_path", {"launches": launches, "closed_loop": res})
    return launches, calls


def _chain_ms(fn, reps):
    """(device ms per call, host ms per call to enqueue) of `reps`
    sequential calls, CUDA events around the chain, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    fn(reps)
    e1.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, host


def mpc_timing_phase(dev, p):
    """Replan latency (a chain of CHAIN replans, each consuming the last
    plan, no host read inside) beside the preview rollout kernel at the
    same shape; the eval control step split into previews and the
    executed step."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.solver import mpc
    m, cfg = p["m"], p["plan_cfg"]
    planner = mpc.make_fused_planner(m, cfg)
    g = torch.Generator(device=dev).manual_seed(16)

    def chain(n=1):
        pl = p["plan0"]
        for _ in range(n):
            pl, _ = planner(p["one"], pl, g)
        return pl

    kw = dict(ik_iters=cfg.preview_ik_iters,
              solve_iters=cfg.preview_solve_iters)
    H, A, pop = cfg.horizon, m.cfg.action_dim, cfg.pop
    rs = np.random.RandomState(17)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (H, A, EVAL_ENVS * pop)),
                        dtype=torch.float32, device=dev)
    X1 = fs.pack_state(m.cfg, m.tree, p["one"]).repeat(1, pop)
    XE = fs.pack_state(m.cfg, m.tree, p["envs"]).repeat_interleave(pop, 1)
    roll = fs.make_cuda_rollout(*m, H, **kw)
    roll_ee = fs.make_cuda_rollout(*m, H, with_ee=True, **kw)
    stepk = fs.make_cuda_step(*m)
    XS = fs.pack_state(m.cfg, m.tree, p["envs"])
    a_exec = acts[0, :, :EVAL_ENVS].contiguous()
    step = mpc.make_batched_fused_mpc_step(
        m, p["eval_cfg"], EVAL_ENVS, with_ee=True,
        cost_fn=tp.mpc_step_cost(m.cfg, p["eval_cfg"].weights))
    ge = torch.Generator(device=dev).manual_seed(18)

    def eval_chain(n=1):
        st, pl = p["envs"], p["plans"]
        for _ in range(n):
            st, pl, _, _ = step(st, pl, ge, p["params"])
        return st

    with torch.no_grad():
        replan, replan_host = _chain_ms(chain, CHAIN)
        a1 = acts[..., :pop].contiguous()
        k1 = time_ms(lambda: roll(X1, a1), 5)
        ev, ev_host = _chain_ms(eval_chain, 5)
        kE = time_ms(lambda: roll_ee(XE, acts), 5)
        kx = time_ms(lambda: stepk(XS, a_exec), 5)
    bound1 = bound_ms(*work(m, pop, H, **kw)["rollout"])
    boundE = bound_ms(*work(m, EVAL_ENVS * pop, H, **kw)["rollout"])
    glue = replan - cfg.iters * k1
    say(f"[mpc replan] pop={pop} H={H} iters={cfg.iters} mppi: "
        f"{replan:.3f} ms per replan (chain of {CHAIN}; host enqueue "
        f"{replan_host:.3f} ms per replan); preview rollout kernel B={pop} "
        f"H={H} ik {kw['ik_iters']}: {k1:.3f} ms (bound {bound1[0]:.4f} ms, "
        f"{bound1[1]}); replan - {cfg.iters} x kernel = {glue:.3f} ms; "
        f"{card()}")
    say(f"[mpc eval step] {EVAL_ENVS} envs x {pop} H={H} iters="
        f"{cfg.iters}: {ev:.3f} ms per control step (host enqueue "
        f"{ev_host:.3f} ms); preview rollout kernel B={EVAL_ENVS * pop} "
        f"with_ee {kE:.3f} ms x {cfg.iters} (bound {boundE[0]:.4f} ms), exec "
        f"step kernel B={EVAL_ENVS} {kx:.3f} ms; rest "
        f"{ev - cfg.iters * kE - kx:.3f} ms; {card()}")
    record("mpc_timing", {
        "replan_ms": replan, "replan_host_ms": replan_host,
        "preview_kernel_ms_B1024": k1, "preview_bound_ms_B1024": bound1[0],
        "replan_glue_ms": glue, "eval_step_ms": ev,
        "eval_step_host_ms": ev_host, "preview_kernel_ms_B4096": kE,
        "preview_bound_ms_B4096": boundE[0], "exec_step_kernel_ms_B4": kx})


# ---------------------------------------------------------------------------
# the multi-device layer (parallel/mesh.py, the sharded paths, the launcher)
# ---------------------------------------------------------------------------

MULTI_SEED = 21
PROFILED = 3                        # sharded replans under torch.profiler


def _collective_ms(prof, n):
    """Per replan, out of a torch.profiler run of n replans: (device ms of
    the NCCL kernels, device ms of every kernel, host ms inside the c10d
    collective calls, the part of it in the profiler's own
    record_param_comms, {kernel or call: count} of those). The device
    times are None where the trace holds no device time at all (CUPTI gave
    nothing)."""
    dev_all = dev_nccl = host = comms = 0.0
    seen = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_all += t
            if "nccl" in e.key.lower():
                dev_nccl += t
                seen[e.key] = e.count
        elif e.key.startswith("c10d::"):
            host += e.cpu_time_total
            seen[e.key] = e.count
        elif e.key == "record_param_comms":
            comms += e.self_cpu_time_total
    per = lambda t: t / 1e3 / n  # noqa: E731
    if dev_all == 0.0:
        return None, None, per(host), per(comms), seen
    return per(dev_nccl), per(dev_all), per(host), per(comms), seen


def multi_phase(dev, m, states, acts, kernel_out, p):
    """[multi]: the sharded paths at world size 1 over NCCL on this card,
    with the launch counts read around them: make_sharded_fused_rollout on
    the main path's B=4096, H=40 inputs, the sharded fused planner by MPPI
    (PLAN_CFG: pop=1024, H=10, 2 iterations) and by CEM, dryrun_multichip
    (1), and the launcher (3 steps, a checkpoint, a relaunch that resumes
    from it). After the counts are read: the sharded rollout must equal
    the main path's rollout and each planner make_fused_planner on the
    same generator, bit for bit (at world size 1 the all-reduces and the
    gather are identities); times beside the unsharded ones, the sharded
    replan's NCCL kernels and collective calls read from a torch.profiler
    trace of it. At world size 1 NCCL only copies on the card: no number
    here says what the collectives cost between cards, and several cards
    are not exercised."""
    import torch.distributed as dist
    import launch_distributed_torch as ld
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import fused as F
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.parallel.dryrun import dryrun_multichip
    from roboticsplayroompybullet_torch.solver import mpc
    from roboticsplayroompybullet_torch.utils import profiling
    t0 = time.perf_counter()
    mesh = M.make_mesh(device="cuda")
    if dist.get_backend() != "nccl" or M.mesh_size(mesh) != 1:
        raise AssertionError(f"[multi] {dist.get_backend()} world of "
                             f"{M.mesh_size(mesh)}, wanted NCCL at 1")
    H = acts.shape[1]
    roll = F.make_sharded_fused_rollout(m, mesh, H)
    cfgs = {"mppi": mpc.MPCConfig(**PLAN_CFG),
            "cem": mpc.MPCConfig(**dict(PLAN_CFG, algorithm="cem"))}
    planners = {a: mpc.make_sharded_fused_planner(m, c, mesh)
                for a, c in cfgs.items()}
    gen = lambda: torch.Generator(device=dev).manual_seed(MULTI_SEED)  # noqa
    ck = os.path.join(ROOT, "build", "multi", "mpc_ckpt.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    argv = ["--ckpt", ck, "--ckpt-every", "3"]

    fs.reset_launch_counts()
    with torch.no_grad():
        sh_states, sh_acts = M.shard_batch(states, mesh), M.shard_batch(acts,
                                                                         mesh)
        got = roll(sh_states, sh_acts)
        plans = {a: pl(p["one"], p["plan0"], gen())
                 for a, pl in planners.items()}
        dry = dryrun_multichip(1)
    out1 = ld.run_loop(ld.parse_args(argv + ["--steps", "3"]))
    out2 = ld.run_loop(ld.parse_args(argv + ["--steps", "4"]))
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    say(f"[multi] launches {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"[multi] the {k} kernel never launched")

    fin, rew, ags = kernel_out
    for name, a, b in ([("rewards", got[1], rew), ("ags", got[2], ags)]
                       + [(k, getattr(got[0], k), v)
                          for k, v in vars(fin).items()]):
        if not torch.equal(a, b):
            raise AssertionError(f"[multi] sharded rollout {name} differs "
                                 "from the main path's")
    with torch.no_grad():
        for a, c in cfgs.items():
            want = mpc.make_fused_planner(m, c)(p["one"], p["plan0"], gen())
            (pl, best), (wpl, wbest) = plans[a], want
            if not (torch.equal(pl.mean, wpl.mean)
                    and torch.equal(pl.sigma, wpl.sigma)
                    and torch.equal(best, wbest)):
                raise AssertionError(f"[multi] sharded {a} planner differs "
                                     "from make_fused_planner")
    say(f"[multi] NCCL world 1: sharded rollout B={acts.shape[0]} H={H} == "
        "main path bit for bit; sharded fused planner (pop="
        f"{cfgs['mppi'].pop}, H={cfgs['mppi'].horizon}) == make_fused_planner"
        " bit for bit, MPPI and CEM")
    for k in ("cem_plan", "fused_plan"):
        if not bool(torch.isfinite(dry[k].mean).all()):
            raise AssertionError(f"[multi] dryrun {k} not finite")
    if not (bool(torch.isfinite(dry["rewards"]).all())
            and bool(torch.isfinite(dry["cem_best"]))
            and bool(torch.isfinite(dry["fused_best"]))):
        raise AssertionError("[multi] dryrun: non-finite rewards or bests")
    if (out1["start"], out1["steps_run"], out2["start"],
            out2["steps_run"]) != (0, 3, 3, 1):
        raise AssertionError(f"[multi] launcher did not resume: {out1}, "
                             f"{out2}")
    say(f"[multi] dryrun_multichip(1) mesh {dry['mesh']}: finite; launcher "
        f"{out1} then {out2}")

    # times: the sharded paths beside the unsharded ones, in one chain
    # order (plain, sharded, sharded, plain) so that both see the same host
    with torch.no_grad():
        ms_roll = time_ms(lambda: roll(sh_states, sh_acts), reps=3)
        g = torch.Generator(device=dev).manual_seed(16)

        def chain_of(planner):
            def chain(n=1):
                pl = p["plan0"]
                for _ in range(n):
                    pl, _ = planner(p["one"], pl, g)
                return pl
            return chain

        sharded = chain_of(planners["mppi"])
        plain = chain_of(mpc.make_fused_planner(m, cfgs["mppi"]))
        runs = {"plain": [], "sharded": []}
        for name in ("plain", "sharded", "sharded", "plain"):
            runs[name].append(_chain_ms(sharded if name == "sharded"
                                        else plain, CHAIN))
        replan, replan_host = (float(np.mean(x)) for x in
                               zip(*runs["sharded"]))
        unsh, unsh_host = (float(np.mean(x)) for x in zip(*runs["plain"]))
        try:
            with profiling.trace(os.path.join(ROOT, "build", "multi",
                                              "trace")) as prof:
                sharded(PROFILED)
                torch.cuda.synchronize()
            nccl_ms, kern_ms, coll_host, comms_ms, seen = _collective_ms(
                prof, PROFILED)
        except RuntimeError as e:            # the profiler, not the path
            say(f"[multi] torch.profiler failed ({e}): not measured")
            nccl_ms = kern_ms = coll_host = comms_ms = seen = None
    main_ms = RESULTS["main_path"]["ms"]
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    say(f"[multi] sharded fused rollout B={acts.shape[0]} H={H}: "
        f"{ms_roll:.3f} ms per call (main path {main_ms:.3f} ms); {card()}")
    say(f"[multi] replan pop={cfgs['mppi'].pop} H={cfgs['mppi'].horizon} "
        f"iters={cfgs['mppi'].iters} mppi, chains of {CHAIN} (plain, "
        f"sharded, sharded, plain): sharded {replan:.3f} ms (host enqueue "
        f"{replan_host:.3f} ms), make_fused_planner {unsh:.3f} ms (host "
        f"{unsh_host:.3f} ms), difference {replan - unsh:.3f} ms; {card()}")
    say(f"[multi] torch.profiler, {PROFILED} sharded replans: per replan "
        f"NCCL kernels {fmt(nccl_ms)} of {fmt(kern_ms)} device time in all "
        f"kernels, host inside c10d collectives {fmt(coll_host)} ({seen} "
        f"in all; the profiler's record_param_comms {fmt(comms_ms)} of it)."
        " World size 1: NCCL copies on one card, nothing crosses between "
        "cards")
    dist.destroy_process_group()
    secs = time.perf_counter() - t0
    record("multi", {"launches": launches, "rollout_ms": ms_roll,
                     "main_path_ms": main_ms, "replan_ms": replan,
                     "replan_host_ms": replan_host, "unsharded_replan_ms": unsh,
                     "unsharded_replan_host_ms": unsh_host,
                     "nccl_kernel_ms": nccl_ms, "kernel_ms": kern_ms,
                     "collective_host_ms": coll_host,
                     "record_param_comms_ms": comms_ms, "phase_s": secs})
    return launches


# ---------------------------------------------------------------------------
# the env layer (envs/core.py, envs/wrapper.py, parallel/rollout.py,
# solver/mpc.py's plan / mpc_rollout)
# ---------------------------------------------------------------------------

GOLDEN_BOUNDS = dict(ee=2e-3, ag=5e-3, q=2e-2)   # tests/test_golden.py:63-77
ENV_B, ENV_STEPS, OOB_B = 4096, 10, 1024
RESET_ENVS = (FLAGSHIP, "pandaPlay-v0")         # 1 block; 2 (block-block)
SETTLE_HELD = "pandaPlay-v0"    # whose first settle launch meets the plain
TABLE_TOP = -0.025             # play scene: static box 0's top face
MOVING = 1e-2                  # m/s: a block on the table still sliding
SETTLE_JAX_POS = 1e-3          # m: a settled block against JAX's
# the UR5Reach MPC demo (tests/test_solver.py:75-91: MPPI, sigma 0.35, 14
# steps) at H=10 and 256 candidates
PLAN_LOOP_CFG = dict(horizon=10, pop=256, iters=2, algorithm="mppi",
                     sigma_init=0.35)
PLAN_LOOP_ENVS, PLAN_LOOP_STEPS, PLAN_LOOP_PLAIN = 3, 14, 2


def counted(fn):
    """(fn's result, the launch counts of its run): every count set to 0
    just before, read just after."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    fs.reset_launch_counts()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, dict(fs.LAUNCHES)


def env_golden_phase(dev):
    """PlayEnv on the card replays the 19 goldens (reset(o=o0), 25 steps,
    the step kernel at B=1). Free-running, ee / ag / q against the golden
    at tests/test_golden.py's bounds, held for each id and quantity where
    the JAX lane twin's own replay (the golden_lane fixture, 25 steps)
    keeps them; elsewhere printed as a known divergence (ROADMAP Queue 3).
    Teacher-forced, from each of the JAX lane replay's states one
    step-kernel launch (all of an id's in one launch) against the replay's
    next state at the one-step bounds; a step outside them is stepped again
    by the plain twin in float64 and fails the phase where the kernel is
    farther from that step than JAX's lane twin (float32) is."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.envs import wrapper
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    gdir = os.path.join(ROOT, "tests", "golden")
    ids = sorted(CATALOG)
    runs = {}

    def drive():
        for env_id in ids:
            z = tp.load(f"golden_lane_{tp.key(env_id)}")
            env = wrapper.make(env_id, seed=7, device=dev)
            env.reset(o=z["o0"])
            ee, ag, q = [], [], []
            for a in z["actions"]:
                obs, _, _, _ = env.step(a)
                ee.append(obs["controllable_achieved_goal"][:3])
                ag.append(obs["achieved_goal"])
                q.append(env.state.q[0].cpu().numpy())
            runs[env_id] = (env.model, z, np.stack(ee), np.stack(ag),
                            np.stack(q))

    t0 = time.perf_counter()
    _, launches = counted(drive)
    secs = time.perf_counter() - t0
    n = sum(len(r[2]) for r in runs.values())
    say(f"[env golden] launches {launches} ({len(ids)} ids, {n} steps, "
        f"{secs:.1f} s)")
    if launches["step"] != n:
        raise AssertionError("env golden: not one step launch a step")
    bad, rows = [], {}
    for env_id in ids:
        m, z, ee, ag, q = runs[env_id]
        T_ = len(ee)
        with np.load(os.path.join(gdir, env_id.replace("-", "_")
                                  + ".npz")) as g:
            err = {"ee": float(np.linalg.norm(ee - g["ee"][:T_],
                                              axis=-1).max()),
                   "ag": float(np.abs(ag - g["ag"][:T_]).max()),
                   "q": float(np.abs(q - g["q"][:T_]).max())}
        lane = {k: float(z[f"err_{k}"].max()) for k in err}
        X0 = torch.tensor(np.concatenate([z["X0"][None], z["X"][:-1]]).T,
                          device=dev).contiguous()
        acts = torch.tensor(z["actions"].T, device=dev).contiguous()
        XJ = torch.tensor(z["X"].T, device=dev)
        pos_rows = position_rows(m.cfg, m.tree, dev)
        with torch.no_grad():
            Xk = fs.make_cuda_step(*m)(X0, acts)
            # a step outside the one-step bounds is stepped again by the
            # plain twin in float64: it counts against the kernel only where
            # the kernel is farther from that step than JAX's lane twin
            out = torch.nonzero(env_error(Xk, XJ, pos_rows) > 1).flatten()
            witness = []
            if len(out):
                Y64 = padded(plain_step(*m), X0[:, out].double(),
                             acts[:, out].double())
                ek = env_error(Xk[:, out], Y64, pos_rows)
                ej = env_error(XJ[:, out], Y64, pos_rows)
                witness = [(int(t) + 1, float(a), float(b))
                           for t, a, b in zip(out, ek, ej)]
            against = [w for w in witness if w[1] > w[2]]
        torch.cuda.synchronize()
        diffs = field_diffs(m.cfg, m.tree, Xk, XJ)
        held = {k: lane[k] < GOLDEN_BOUNDS[k] for k in err}
        free_bad = [k for k in err if held[k]
                    and not err[k] < GOLDEN_BOUNDS[k]]
        say(f"[env golden] {env_id}: free-running vs golden " + ", ".join(
            f"{k} {err[k]:.3e} (JAX lane {lane[k]:.3e}, "
            + (f"<{GOLDEN_BOUNDS[k]:g})" if held[k] else
               "not held: known divergence)")
            for k in err)
            + f"; teacher-forced vs JAX lane, worst of {len(ee)} steps: "
            + ", ".join(f"{k} {v[0]:.2e}" for k, v in diffs.items())
            + "; steps outside the one-step bounds, each (step, kernel and "
            "JAX from the float64 step in units of the bounds): "
            + (", ".join(f"({t}, {a:.3f}, {b:.3f})" for t, a, b in witness)
               or "none")
            + f"; kernel farther {len(against)} (none) "
            f"{'ok' if not free_bad and not against else 'FAIL'}")
        rows[env_id] = {"free": err, "jax_lane": lane, "held": held,
                        "teacher_forced": {k: {"max": v[0], "p99": v[1]}
                                           for k, v in diffs.items()},
                        "steps_outside": witness,
                        "against_kernel": against}
        if free_bad or against:
            bad.append((env_id, free_bad, against))
    record("env_golden", {"launches": launches, "seconds": secs,
                          "ids": rows})
    if bad:
        raise AssertionError(f"env golden outside the bounds: {bad}")
    return launches


def _blocks(m, st):
    """(on the table top: centre within 5 mm of half a block above it,
    moving: on it and faster than MOVING, the lowest centre z) of the
    settled blocks of st, flattened over envs and blocks."""
    z = st.obj_pos[..., 2].flatten()
    hz = float(m.scene.block_half[2])
    speed = torch.linalg.vector_norm(st.obj_vel, dim=-1).flatten()
    on = (z - (TABLE_TOP + hz)).abs() < 5e-3
    return on, on & (speed > MOVING), float(z.min())


def _shares_like_jax(tag, m, st, jax_shares, two_sided):
    """The share of blocks on the table top and, of those, the share still
    moving, against JAX's random placement and settle (the settle
    fixture): two-sided within 3 sigma of the two binomial samples for a
    single placement, which JAX's is; for a whole reset (its re-place loop
    may only take blocks that settled out of bounds off the floor) the
    share on the table at least JAX's less 3 sigma and the moving share at
    most JAX's plus 3 sigma. No block sunk into the floor by more than a
    quarter of its height (one that tipped off the table may be
    landing)."""
    on, moving, z_min = _blocks(m, st)
    hz = float(m.scene.block_half[2])
    out, bad = {"z_min": z_min}, z_min < float(m.scene.plane_z) + hz / 2
    for name, k, n_k, (p_j, n_j) in (
            ("on the table", int(on.sum()), on.numel(), jax_shares["on"]),
            ("of them moving", int(moving.sum()), int(on.sum()),
             jax_shares["moving"])):
        p_k = k / n_k
        pool = (p_k * n_k + p_j * n_j) / (n_k + n_j)
        sig = (pool * (1 - pool) * (1 / n_k + 1 / n_j)) ** 0.5
        lo, hi = max(p_j - 3 * sig, 0.0), min(p_j + 3 * sig, 1.0)
        if not two_sided:
            lo, hi = (lo, 1.0) if name == "on the table" else (0.0, hi)
        ok = lo <= p_k <= hi
        bad |= not ok
        out[name] = {"share": p_k, "n": n_k, "jax": p_j, "jax_n": n_j,
                     "lo": lo, "hi": hi}
        say(f"[{tag}] blocks {name}: {100 * p_k:.2f} % of {n_k} (JAX "
            f"{100 * p_j:.2f} % of {n_j}; held in [{100 * lo:.2f}, "
            f"{100 * hi:.2f}] %) {'ok' if ok else 'FAIL'}")
    say(f"[{tag}] blocks: lowest centre z {z_min:.4f} m (floor "
        f"{float(m.scene.plane_z):.4f})")
    if bad:
        raise AssertionError(f"{tag}: settled blocks unlike JAX's: {out}")
    return out


def settle_vs_jax(dev, env_id):
    """reset's placement and settle (core._place_and_settle: one sim-kernel
    launch of 100 substeps) on the settle fixture's envs, with the U(0, 1)
    draws jax.random made patched into core._uniform, against JAX's settle
    of the same placements (its oracle physics): every block on the table
    top where JAX's is and nowhere else, and within SETTLE_JAX_POS of
    JAX's position, in all but ceil(MAX_FLIPS * B / ENV_B) envs (the
    share of envs a B=4096 launch may leave the one-step bounds of the
    plain twin through float32 reordering). Returns JAX's shares of blocks
    on the table and moving ({name: (share, n)})."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    z = tp.load(f"settle_{tp.key(env_id)}")
    m = core.build_model(CATALOG[env_id])
    u = torch.tensor(z["u"], device=dev)
    B = u.shape[0]
    uniform = core._uniform
    core._uniform = lambda gen, shape, device: u.reshape(shape)
    try:
        with torch.no_grad():
            st = core._place_and_settle(m, core._default_state(m, B, dev),
                                        None)
    finally:
        core._uniform = uniform
    jst = SimpleNamespace(obj_pos=torch.tensor(z["out_obj_pos"],
                                               device=dev),
                          obj_vel=torch.tensor(z["out_obj_vel"], device=dev))
    on_j, mov_j, _ = _blocks(m, jst)
    on_k, _, _ = _blocks(m, st)
    no = m.cfg.num_objects
    dpos = torch.linalg.vector_norm(st.obj_pos - jst.obj_pos, dim=-1)
    env_bad = ((on_k != on_j).reshape(B, no).any(-1)
               | (dpos > SETTLE_JAX_POS).any(-1))
    allow = -(-MAX_FLIPS * B // ENV_B)
    n_bad = int(env_bad.sum())
    jax_shares = {"on": (float(on_j.float().mean()), on_j.numel()),
                  "moving": (float(mov_j.sum()) / float(on_j.sum()),
                             int(on_j.sum()))}
    say(f"[env reset {env_id} settle vs JAX] B={B}, JAX's draws: blocks on "
        f"the table {int(on_k.sum())} (JAX {int(on_j.sum())}) of "
        f"{on_j.numel()}, on it in one and not the other "
        f"{int((on_k != on_j).sum())}; position vs JAX max "
        f"{float(dpos.max()):.3e} p99 {float(torch.quantile(dpos, 0.99)):.3e}"
        f" m (<={SETTLE_JAX_POS:g}); envs outside {n_bad} "
        f"{torch.nonzero(env_bad).flatten().tolist()} (<={allow}) "
        f"{'ok' if n_bad <= allow else 'FAIL'}")
    record(f"env reset {env_id} settle vs JAX", {
        "B": B, "on_table": int(on_k.sum()), "jax_on_table": int(on_j.sum()),
        "disagree": int((on_k != on_j).sum()), "pos_max": float(dpos.max()),
        "envs_outside": n_bad, "allowed": allow, "jax_shares": jax_shares})
    if n_bad > allow:
        raise AssertionError(f"{env_id}: settle unlike JAX's in {n_bad} "
                             "envs")
    return jax_shares


def env_reset_phase(dev):
    """batched_reset at B=4096 on the flagship and the 2-block pandaPlay,
    with the launch counts read around it: every object in bounds, every
    reward −1, and the attempts taken. The settle against JAX's
    (settle_vs_jax, on JAX's own draws), then the blocks of the first
    settle launch (one placement of all B envs, as JAX's fixture is) and
    of the finished reset against JAX's shares on the table and moving
    (_shares_like_jax). SETTLE_HELD's first settle launch (the sim kernel,
    100 substeps, at its own B) is held to the plain twin,
    teacher-forced-step style: each field's p99 within the one-step
    bounds, positions within ROLLOUT_MAX, and at most MAX_FLIPS envs
    outside the one-step bounds (a resting block's angular velocity flips
    under rounding, bench.py:258-263; a tipping block's path is chaotic)
    or, past that, at most MAX_FLIPS of them farther from the plain twin's
    float64 settle than its float32 one is. Then the out-of-bounds case of
    tests/test_env.py:140-167 (pandaPush with env_range_high.x = 0) at
    B=1024 must end in bounds, and the flagship's reset is timed."""
    import dataclasses
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs.rewards import compute_reward
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import rollout as R
    total = {"sim": 0, "step": 0, "rollout": 0}
    res = {}
    for env_id in RESET_ENVS + ("pandaPush-v0 x<=0",):
        if env_id.startswith("pandaPush"):
            m = core.build_model(dataclasses.replace(
                CATALOG["pandaPush-v0"], env_range_high=(0.0, 0.18, -0.04)))
            B = OOB_B
        else:
            m = core.build_model(CATALOG[env_id])
            B = ENV_B
        stats = {}
        gen = torch.Generator(device=dev).manual_seed(20)
        t0 = time.perf_counter()
        with first_calls() as calls:
            (st, obs), launches = counted(
                lambda: R.batched_reset(m, gen, B, dev, stats))
        secs = time.perf_counter() - t0
        for k in total:
            total[k] += launches[k]
        tag = f"env reset {env_id} B={B}"
        oob = int(core._objects_oob(m.cfg, st).sum())
        r = compute_reward(m.cfg, obs["achieved_goal"], obs["desired_goal"])
        resets, placed = stats["resets"], stats["placements"]
        row = {"launches": launches, "seconds_first_call": secs,
               "oob": oob, "rewards_not_minus_1": int((r != -1).sum()),
               "resets_max": int(resets.max()),
               "resets_mean": float(resets.float().mean()),
               "placements_max": int(placed.max()),
               "placements_mean": float(placed.float().mean())}
        say(f"[{tag}] launches {launches}; {oob} envs out of bounds, "
            f"{row['rewards_not_minus_1']} rewards not -1; draws per env "
            f"mean {row['resets_mean']:.4f} max {row['resets_max']}, "
            f"placements (100-substep settles) per env mean "
            f"{row['placements_mean']:.4f} max {row['placements_max']}; "
            f"{secs:.2f} s (first call)")
        if launches["sim"] < 1 or oob or row["rewards_not_minus_1"]:
            raise AssertionError(f"{tag}: no settle launch, objects out of "
                                 "bounds or a solved env")
        if env_id.startswith("pandaPush"):
            res[env_id] = row
            continue
        c = next(c for c in calls if c["entry"] == "sim")
        X, ctrl, grip = c["inputs"]
        with torch.no_grad():
            Xk = fs.make_cuda_sim(*m, n_substeps=core.SETTLE_SUBSTEPS)(
                X, ctrl, grip)
        jax_shares = settle_vs_jax(dev, env_id)
        first = fs.unpack_state(m.cfg, m.tree, Xk,
                                core._default_state(m, X.shape[1], dev))
        row["blocks_first_settle"] = _shares_like_jax(
            f"{tag} first settle launch B={X.shape[1]}", m, first,
            jax_shares, two_sided=True)
        row["blocks"] = _shares_like_jax(tag, m, st, jax_shares,
                                         two_sided=False)
        if env_id == SETTLE_HELD:
            with torch.no_grad():
                t1 = time.perf_counter()
                Yp = plain_sim(*m, n_substeps=core.SETTLE_SUBSTEPS)(
                    X, ctrl, grip)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t1
            pos_rows = position_rows(m.cfg, m.tree, dev)
            diffs, flips, pmax, over = judge_step(m.cfg, m.tree, pos_rows,
                                                  Xk, Yp)
            # an env outside the one-step bounds is settled again by the
            # plain twin in float64; it counts against the kernel only
            # where the kernel is farther from that than the float32 twin
            f = torch.nonzero(env_error(Xk, Yp, pos_rows) > 1).flatten()
            if flips <= MAX_FLIPS:      # nothing to witness
                f = f[:0]
            with torch.no_grad():
                Y64 = padded(plain_sim(
                    *m, n_substeps=core.SETTLE_SUBSTEPS),
                    X[:, f].double(), ctrl[:, f].double(),
                    grip[f].double()) if len(f) else None
            ek = env_error(Xk[:, f], Y64, pos_rows) if len(f) else []
            ep = env_error(Yp[:, f], Y64, pos_rows) if len(f) else []
            against = (int(sum(float(a) > float(b) for a, b in zip(ek, ep)))
                       if len(f) else flips)
            say(f"[{tag}] first settle launch (sim kernel, "
                f"{core.SETTLE_SUBSTEPS} substeps, B={X.shape[1]}) vs the "
                "plain twin: " + ", ".join(
                    f"{k} max {v[0]:.2e} p99 {v[1]:.2e}"
                    for k, v in diffs.items())
                + f"; envs outside the one-step bounds {flips} (env: kernel"
                " vs float64, float32 plain vs float64, in units of the "
                "bounds: " + ", ".join(
                    f"{int(e)}: {float(a):.2f} {float(b):.2f}"
                    for e, a, b in zip(f, ek, ep))
                + f"), of them farther from the float64 settle than the "
                f"plain twin {against} (<={MAX_FLIPS}); plain {plain_s:.1f}"
                f" s; {card()}")
            row["settle_vs_plain"] = {
                "fields": {k: {"max": v[0], "p99": v[1]}
                           for k, v in diffs.items()},
                "flips": flips, "against_kernel": against,
                "B": X.shape[1], "plain_s": plain_s}
            if over or pmax >= ROLLOUT_MAX or against > MAX_FLIPS:
                raise AssertionError(f"{tag}: settle kernel outside the "
                                     f"bounds: {over}, {pmax}, {flips}")
        res[env_id] = row

    # the reset's time once the kernels and constants are in place, and
    # the settle launch alone at B=4096 beside its bound
    m = core.build_model(CATALOG[FLAGSHIP])
    gen = torch.Generator(device=dev).manual_seed(22)
    with torch.no_grad():
        ms = time_ms(lambda: R.batched_reset(m, gen, ENV_B, dev), 1,
                     warm=False)        # warm: its first call came above
        st = flagship_states(ENV_B, dev, seed=23)
        X = fs.pack_state(m.cfg, m.tree, st)
        sim = fs.make_cuda_sim(*m, n_substeps=core.SETTLE_SUBSTEPS)
        ctrl, grip = st.ctrl_q.T.contiguous(), st.grip.contiguous()
        k_ms = time_ms(lambda: sim(X, ctrl, grip), 3)
    m100 = core.EnvModel(dataclasses.replace(
        m.cfg, substeps=core.SETTLE_SUBSTEPS), m.tree, m.arm, m.scene)
    b_ms, by = bound_ms(*work(m100, ENV_B, 1)["sim"])
    say(f"[env reset] {FLAGSHIP} B={ENV_B}: {ms:.3f} ms per batched_reset; "
        f"settle launch alone (sim kernel, {core.SETTLE_SUBSTEPS} substeps) "
        f"{k_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), "
        f"{100 * b_ms / k_ms:.2f} % of the bound; {card()}")
    record("env_reset", dict(res, reset_ms=ms, settle_kernel_ms=k_ms,
                             settle_bound_ms=b_ms, settle_bound_by=by))
    return total


def env_step_phase(dev):
    """BatchedEnv at B=4096 on the flagship: ENV_STEPS steps with the launch
    counts read around them; env steps/s and ms per step split into the
    step kernel and calc_obs + reward + buffers; one step held to the
    plain twin (state per field, the servo targets, then the obs); the
    latency of PlayEnv.step at B=1."""
    from roboticsplayroompybullet_torch.envs import core, wrapper
    from roboticsplayroompybullet_torch.envs import obs as O
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    env = wrapper.make(FLAGSHIP, ENV_B, seed=24, device=dev)
    m = env.model
    rs = np.random.RandomState(25)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (ENV_STEPS, ENV_B,
                                                 m.cfg.action_dim)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        env.reset()
    st0 = env.state

    def drive():
        out = None
        for a in acts:
            out = env.step(a)
        return out

    (obs, r, done, info), launches = counted(drive)
    say(f"[env step] launches {launches} ({ENV_STEPS} steps of "
        f"BatchedEnv B={ENV_B})")
    if launches["step"] != ENV_STEPS or bool(done.any()):
        raise AssertionError("env step: not one step launch a step, or done")
    if not all(bool(torch.isfinite(v).all()) for v in obs.values()):
        raise AssertionError("env step: non-finite obs")
    if not bool((env.state.t == st0.t + ENV_STEPS).all()):
        raise AssertionError("env step: t not advanced")

    # one step against the plain twin at B=4096
    X = fs.pack_state(m.cfg, m.tree, st0)
    a0 = acts[0].T.contiguous()
    with torch.no_grad():
        Xk, Ck = core._stepper(m)(X, a0)
        Xp, Cp = plain_step(*m, with_ctrl=True)(X, a0)
    torch.cuda.synchronize()
    err = check_fields(f"env step B={ENV_B} kernel vs plain",
                       field_diffs(m.cfg, m.tree, Xk, Xp))
    dc = (Ck - Cp).abs().flatten()
    cp99, cmax = float(torch.quantile(dc, 0.99)), float(dc.max())
    say(f"[env step B={ENV_B} kernel vs plain] servo targets and grip: "
        f"p99={cp99:.3e} (<=1e-3) max={cmax:.3e} (<=0.1)")
    if cp99 > 1e-3 or cmax > 0.1:
        raise AssertionError("env step: servo targets differ from the plain")
    ok_ = {}
    sk = fs.unpack_state(m.cfg, m.tree, Xk, st0)
    sp = fs.unpack_state(m.cfg, m.tree, Xp, st0)
    with torch.no_grad():
        ok, op = O.calc_obs(*m, sk), O.calc_obs(*m, sp)
    for k in ok:
        d = (ok[k] - op[k]).abs()
        if k == "observation":        # Euler angles: equal modulo 2π
            e = d[:, 3:6]
            d = torch.cat([d[:, :3], torch.minimum(e, 2 * np.pi - e),
                           d[:, 6:]], dim=-1)
        if k == "gripper_proprioception":
            n = int((d > 0).sum())
            ok_[k] = n
            good = n <= MAX_FLIPS
        elif k == "velocity":
            ok_[k] = float(d.max())
            good = (float(torch.quantile(d.flatten(), 0.99)) <= VEL_P99
                    and ok_[k] <= VEL_MAX)
        else:
            ok_[k] = float(d.max())
            good = ok_[k] <= POS_MAX
        if not good:
            raise AssertionError(f"env step obs {k} differs: {ok_[k]}")
    say(f"[env step B={ENV_B} kernel vs plain] obs max " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v} envs differ"
        for k, v in ok_.items()) + f" ok; {card()}")

    # timing: the whole env step, the kernel alone
    stepk = core._stepper(m)
    Xs = fs.pack_state(m.cfg, m.tree, env.state)
    with torch.no_grad():
        full = time_ms(lambda: env.step(acts[0]), ENV_STEPS)
        kern = time_ms(lambda: stepk(Xs, a0), ENV_STEPS)
        one = wrapper.make(FLAGSHIP, seed=26, device=dev)
        one.reset()
        a1 = rs.uniform(-0.25, 0.25, m.cfg.action_dim).astype(np.float32)
        one.step(a1)
        t0 = time.perf_counter()
        for _ in range(ENV_STEPS):
            one.step(a1)
        lat = (time.perf_counter() - t0) * 1e3 / ENV_STEPS
    say(f"[env step] BatchedEnv B={ENV_B}: {full:.3f} ms per step, "
        f"{ENV_B / (full / 1e3):.1f} env steps/s; step kernel {kern:.3f} ms,"
        f" calc_obs + reward + buffers {full - kern:.3f} ms; PlayEnv.step "
        f"B=1 latency {lat:.3f} ms (host clock, numpy out); {card()}")
    record("env_step", {"launches": launches, "ms_per_step": full,
                        "env_steps_per_s": ENV_B / (full / 1e3),
                        "kernel_ms": kern, "rest_ms": full - kern,
                        "playenv_step_ms": lat, "obs_vs_plain": ok_,
                        "state_vs_plain_max": err,
                        "ctrl_vs_plain": {"p99": cp99, "max": cmax}})
    return launches


RENDER_STEPS = 5           # recorded PlayEnv steps before the sub-goal
FRAME_B, FRAME_REPS = 64, 10


def render_phase(dev):
    """The camera path on the flagship at 200x200 (utils/render.py,
    PlayEnv's camera half, tools/teleop_bridge_torch.py), with the launch
    counts read around it: PlayEnv reset (its settle an fs_sim launch),
    render("rgb_array"), RENDER_STEPS recorded steps (one fs_step each), a
    full_positional_state sub-goal drawn (the ghost arm's IK on the card)
    and deleted, render("human") writing a PNG on a recorded step, and a
    Bridge on the card answering reset / step / sub_goal / close. Every
    frame is held by the pixel rule (tests/_torch_port.py::pixel_rule) to
    the port's render of the same state copied to the CPU, and obs["img"]
    is the uint8 of the card's float frame. Then ms per frame at B=1 and
    B=FRAME_B (CUDA events after a warm-up), and PlayEnv.step latency
    without and with recording."""
    import _torch_port as tp
    import teleop_bridge_torch as tb
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import wrapper
    from roboticsplayroompybullet_torch.utils import render as rnd
    env = wrapper.make(FLAGSHIP, seed=27, device=dev)
    m = env.model
    rs = np.random.RandomState(27)
    acts = rs.uniform(-0.25, 0.25, (RENDER_STEPS + 1, m.cfg.action_dim)
                      ).astype(np.float32)
    png = os.path.join(ROOT, "build", "render", "human.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    held = []               # (tag, uint8 frame, state, ghosts) to check

    def shot(tag, frame):
        held.append((tag, frame, env.state, env._ghost_inputs()))
        return frame

    def drive():
        obs = env.reset()
        shot("reset", env.render("rgb_array"))
        for t in range(RENDER_STEPS):
            out = env.step(acts[t])
            shot(f"step {t}", out[0]["img"])
        sub = moved_sub_goal(obs["full_positional_state"])
        env.visualise_sub_goal(sub, "full_positional_state")
        shot("sub-goal", env.render("rgb_array"))
        env.delete_sub_goal()
        shot("deleted", env.render("rgb_array"))
        env.human_render_path, env.human_render_every = png, 1
        env.render("human")
        out = env.step(acts[RENDER_STEPS])
        return shot("human step", out[0]["img"]), sub

    (last, sub), launches = counted(drive)
    steps = RENDER_STEPS + 1
    if launches["step"] != steps or launches["sim"] < 1:
        raise AssertionError(f"render: launches {launches}, not one fs_step "
                             f"a step ({steps}) and a settle")
    b = tb.Bridge(FLAGSHIP, seed=28, device=dev)

    def ask():
        out = [b.handle({"cmd": "reset"}),
               b.handle({"cmd": "step", "action": acts[0].tolist()})]
        fps = b.handle({"cmd": "state"})["obs"]["full_positional_state"]
        return out + [b.handle({"cmd": "sub_goal", "sub_goal":
                                moved_sub_goal(fps).tolist(),
                                "kind": "full_positional_state"}),
                      b.handle({"cmd": "close"})]

    answers, bridge_launches = counted(ask)
    if not all(a["ok"] for a in answers) or not answers[-1].get("closed"):
        raise AssertionError(f"render: the bridge answered {answers}")
    if bridge_launches["step"] != 1 or bridge_launches["sim"] < 1:
        raise AssertionError(f"render: bridge launches {bridge_launches}")
    say(f"[render] launches {launches} (PlayEnv: reset, {steps} recorded "
        f"steps), bridge {bridge_launches} (reset, step, sub_goal, close)")

    worst = {}
    for tag, frame, st, (g, gb) in held:
        with torch.no_grad():
            img = rnd.render_state(*m, st, ghosts=g, ghost_boxes=gb)[0]
            cpu = lambda x: None if x is None else tuple(  # noqa: E731
                a.cpu() for a in x)
            ref = rnd.render_state(
                *m, interop.state_from_numpy(interop.state_to_numpy(st),
                                             "cpu"),
                ghosts=cpu(g), ghost_boxes=cpu(gb))[0]
        img = img.cpu().numpy()
        ok, outliers = tp.pixel_rule(img, ref.numpy())
        worst[tag] = outliers
        if not ok:
            raise AssertionError(f"render {tag}: card vs CPU frame off the "
                                 f"pixel rule ({outliers} channel values)")
        if frame.shape != (rnd.PIXELS, rnd.PIXELS, 3) or not np.array_equal(
                frame, (img * 255).astype(np.uint8)):
            raise AssertionError(f"render {tag}: the uint8 frame is not the "
                                 "float frame's")
    frames = {tag: frame for tag, frame, _, _ in held}
    changed = float((frames["sub-goal"] != frames["step "
                                                 f"{RENDER_STEPS - 1}"]
                     ).any(-1).mean())
    if changed < 0.01 or not np.array_equal(
            frames["deleted"], frames[f"step {RENDER_STEPS - 1}"]):
        raise AssertionError(f"render: the sub-goal changed {changed:.4f} "
                             "of the pixels, or deleting it left a change")
    want = os.path.join(os.path.dirname(png), "want.png")
    rnd.write_png(want, last)
    with open(png, "rb") as f, open(want, "rb") as g_:
        if f.read() != g_.read():
            raise AssertionError("render: the human PNG is not the frame")
    say(f"[render] {len(held)} frames (reset, {RENDER_STEPS} recorded steps,"
        f" sub-goal {100 * changed:.1f} % of the pixels changed, deleted, "
        "human step) on the card vs the CPU render: pixel rule (|d| <= "
        f"{tp.PIXEL_TOL} on >= {100 * tp.PIXEL_SHARE} % a channel) ok, "
        f"outlying channel values {worst}; uint8 frames exact; human PNG ok")

    # timing: a frame at B=1 (plain, with the sub-goal's ghosts) and B=64
    with torch.no_grad():
        st = env.state
        ms1 = time_ms(lambda: rnd.render_state(*m, st), FRAME_REPS)
        env.visualise_sub_goal(sub, "full_positional_state")
        g, gb = env._ghost_inputs()
        ms1g = time_ms(lambda: rnd.render_state(*m, st, ghosts=g,
                                                ghost_boxes=gb), FRAME_REPS)
        env.delete_sub_goal()
        many = flagship_states(FRAME_B, dev, 29)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        msb = time_ms(lambda: rnd.render_state(*m, many), FRAME_REPS)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        lat = {}
        for rec in (False, True):
            if rec:
                b.env.render("rgb_array")
            out = b.env.step(acts[0])
            if (out[0]["img"] is None) == rec:
                raise AssertionError("render: obs['img'] not as recording")
            t0 = time.perf_counter()
            for a in acts:
                b.env.step(a)
            lat[rec] = (time.perf_counter() - t0) * 1e3 / len(acts)
    say(f"[render] 200x200 frame: B=1 {ms1:.3f} ms ({ms1g:.3f} ms with the "
        f"sub-goal's ghosts), B={FRAME_B} {msb:.3f} ms = {msb / FRAME_B:.3f} "
        f"ms a frame, peak {peak:.1f} MiB; PlayEnv.step latency without "
        f"recording {lat[False]:.3f} ms, with {lat[True]:.3f} ms (host "
        f"clock); {card()}")
    record("render", {"launches": launches, "bridge_launches":
                      bridge_launches, "outliers": worst,
                      "sub_goal_changed": changed, "frame_ms_b1": ms1,
                      "frame_ms_b1_ghosts": ms1g,
                      f"frame_ms_b{FRAME_B}": msb, "peak_mib": peak,
                      "playenv_step_ms": lat[False],
                      "playenv_step_recording_ms": lat[True]})
    return {k: launches[k] + bridge_launches[k] for k in launches}


def moved_sub_goal(fps):
    """A flagship full_positional_state sub-goal: `fps` with the ee and
    the block moved 6 and 5 cm."""
    sub = np.array(fps, np.float32)
    sub[:3] += np.array([0.06, -0.06, 0.06], np.float32)
    sub[8:11] += np.array([0.05, 0.05, 0.0], np.float32)
    return sub


def plan_loop_phase(dev):
    """mpc_rollout (the single-device planner at the env step's fidelity,
    one rollout launch a refinement, one step launch a control step) on
    UR5Reach from PLAN_LOOP_ENVS random resets, PLAN_LOOP_CFG, for
    PLAN_LOOP_STEPS steps, with the launch counts read around it: each EE-
    goal distance must end below REACH_SHRINK of its start. Its first
    rollout launch (B=256, H=10, full fidelity) is held to the plain twin
    teacher-forced over its first PLAN_LOOP_PLAIN steps and to 10 step
    launches bit for bit, its first step launch per field; then ms per
    replan."""
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.envs.obs import achieved_goal
    from roboticsplayroompybullet_torch.envs.state import EnvState
    from roboticsplayroompybullet_torch.parallel import rollout as R
    from roboticsplayroompybullet_torch.solver import cost, mpc
    m = core.build_model(CATALOG["UR5Reach-v0"])
    cfg = mpc.MPCConfig(**PLAN_LOOP_CFG)
    with torch.no_grad():
        starts, _ = R.batched_reset(
            m, torch.Generator(device=dev).manual_seed(27), PLAN_LOOP_ENVS,
            dev)
    starts = [EnvState(**{k: v[i:i + 1] for k, v in vars(starts).items()})
              for i in range(PLAN_LOOP_ENVS)]
    dist = lambda s: float(cost.goal_distance(  # noqa: E731
        m.cfg, achieved_goal(m.cfg, m.tree, m.arm, s), s.goal)[0])
    loops = []

    def drive():
        for i, s0 in enumerate(starts):
            loops.append(mpc.mpc_rollout(
                m, cfg, s0, torch.Generator(device=dev).manual_seed(28 + i),
                PLAN_LOOP_STEPS))

    with first_calls() as log:
        _, launches = counted(drive)
    say(f"[mpc plan loop] launches {launches}")
    want = PLAN_LOOP_ENVS * PLAN_LOOP_STEPS
    if launches["rollout"] != want * cfg.iters or launches["step"] != want:
        raise AssertionError("mpc plan loop: not one rollout launch a "
                             "refinement and one step launch a step")
    res = []
    for i, (s0, (fin, acts, rws, bests)) in enumerate(zip(starts, loops)):
        d0, d1 = dist(s0), dist(fin)
        ok = (d1 < REACH_SHRINK * d0 and bool(torch.isfinite(bests).all())
              and acts.shape == (PLAN_LOOP_STEPS, m.cfg.action_dim))
        say(f"[mpc plan loop] UR5Reach env {i}, mpc_rollout MPPI H="
            f"{cfg.horizon} pop={cfg.pop} sigma {cfg.sigma_init}: EE-goal "
            f"distance {d0:.4f} -> {d1:.4f} m in {PLAN_LOOP_STEPS} steps, "
            f"ratio {d1 / d0:.3f} (<{REACH_SHRINK:g}) "
            f"{'ok' if ok else 'FAIL'}; {card()}")
        res.append({"d0": d0, "d1": d1})
        if not ok:
            raise AssertionError(f"mpc plan loop env {i}: {d0} -> {d1}")
    mpc_shapes_phase({"plan loop": log}, plain_steps=PLAN_LOOP_PLAIN)

    g = torch.Generator(device=dev).manual_seed(31)

    def chain(n=1):
        pl = mpc.init_plan(m, cfg, device=dev)
        for _ in range(n):
            pl, _ = mpc.plan(m, cfg, starts[0], pl, g)
        return pl

    with torch.no_grad():
        ms, host = _chain_ms(chain, CHAIN)
    say(f"[mpc plan loop] plan pop={cfg.pop} H={cfg.horizon} iters="
        f"{cfg.iters} full fidelity: {ms:.3f} ms per replan (chain of "
        f"{CHAIN}; host enqueue {host:.3f} ms); {card()}")
    record("mpc_plan_loop", {"launches": launches, "loops": res,
                             "replan_ms": ms, "replan_host_ms": host})
    return launches


# ---------------------------------------------------------------------------
# the task-competence eval (solver/eval.py, tools/eval_mpc_torch.py)
# ---------------------------------------------------------------------------

PANDA_PLAY = "pandaPlayAbsRPY1Obj-v0"
PLAY_FAMILIES = ("block", "drawer", "door", "button", "dial")
EVAL_STEPS = 5       # control steps a family (block 1.5x, pick's carry)
EVAL_TIMED = 5       # eval control steps timed a model, in one chain


def eval_phase(dev):
    """run_eval for the 12 families of tools/eval_mpc_torch.py at the
    sweep's width (4 envs x 1024 candidates, H=10, 2 MPPI iterations,
    sigma 0.3) and depth cut to one batch of 4 episodes and EVAL_STEPS
    control steps (block 1.5x; pick keeps its 70 acquire steps and
    carries for EVAL_STEPS), with the launch counts read around it. The
    rates are printed, not held: 4 episodes at a cut depth say little (the
    sweep's EVAL_TORCH.json holds them). Each stats record must be whole
    and every kernel must have launched. Then the path's own launches are
    held to the plain twin (mpc_shapes_phase): the first preview launch of
    each model new to the MPC path (UR5Reach, pandaPlayAbsRPY1Obj and
    pandaPick at B=4096, H=10, ik 8 / solve 8) step by step, teacher-forced
    with the float64 witness; the first executed B=4 step of each of the
    four models and pick's first acquisition step, per field. Last, ms per
    eval control step of each model (a chain of EVAL_TIMED steps with its
    family cost) beside its preview kernel at B=4096 and the executed
    step."""
    import _torch_port as tp
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.parallel import rollout as R
    from roboticsplayroompybullet_torch.solver import eval as E
    from roboticsplayroompybullet_torch.solver import mpc
    REACH_ID, PICK_ID = E.REACH_ID, E.PICK_ID
    cfg = mpc.MPCConfig(**PLAN_CFG)._replace(sigma_init=EVAL_SIGMA)
    kw = dict(mpc=cfg, n_episodes=EVAL_ENVS, n_envs=EVAL_ENVS,
              n_steps=EVAL_STEPS, seed=0, device=dev)

    def drive():
        res = E.run_eval(E.GOAL_FAMILIES + (E.PICK_FAMILY,), env_id=FLAGSHIP,
                         **kw)
        panda = E.run_eval(PLAY_FAMILIES, env_id=PANDA_PLAY, **kw)
        res.update({f"panda_{k}": v for k, v in panda.items()})
        return res

    t0 = time.perf_counter()
    with first_calls() as log:
        res, launches = counted(drive)
    wall = time.perf_counter() - t0
    say(f"[eval] launches {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"eval: the {k} kernel never launched")
    for fam, r in res.items():
        say(f"[eval] {fam}: {r['n_success']}/{r['n_episodes']} solved in "
            f"{r['n_steps']} steps (not held), {r['wall_s']} s, resets "
            f"{r['reset_s']} s; {card()}")
        if (r["n_episodes"] != EVAL_ENVS or not 0 <= r["n_success"] <= 4
                or not np.isfinite(r["wall_s"])):
            raise AssertionError(f"eval {fam}: {r}")
    if len(res) != 12:
        raise AssertionError(f"eval: {sorted(res)}")
    say(f"[eval] 12 families in {wall:.1f} s (resets "
        f"{sum(r['reset_s'] for r in res.values()):.1f} s)")

    # hold the path's first launches: previews of the new models, the
    # executed steps of every model and pick's first acquisition step
    names = {CATALOG[i]: tp.key(i) for i in (FLAGSHIP, REACH_ID, PANDA_PLAY,
                                             PICK_ID)}
    held = {}
    for c in log:
        name = names.get(c["m"][0])
        B = c["inputs"][0].shape[1]
        if c["entry"] == "rollout" and name != tp.key(FLAGSHIP) \
                and B == EVAL_ENVS * cfg.pop:
            held.setdefault(f"eval {name}", []).append(c)
        elif c["entry"] == "step" and B == EVAL_ENVS:
            piece = f"eval {name}" + (" acquire" if c["kw"].get("with_ctrl")
                                      else "")
            held.setdefault(piece, []).append(c)
    want = {f"eval {tp.key(i)}" for i in (REACH_ID, PANDA_PLAY, PICK_ID)}
    want.add(f"eval {tp.key(PICK_ID)} acquire")
    if not want <= set(held):
        raise AssertionError(f"eval: launches to hold missing: {sorted(held)}")
    mpc_shapes_phase(held)

    timed = {}
    for env_id, fam in ((FLAGSHIP, "drawer"), (REACH_ID, "reach"),
                        (PANDA_PLAY, "drawer"), (PICK_ID, E.PICK_FAMILY)):
        m = core.build_model(CATALOG[env_id])
        skw, params = E._family_cost(m, fam, EVAL_ENVS, dev)
        with_ee = skw.get("with_ee", False)
        step = mpc.make_batched_fused_mpc_step(m, cfg, EVAL_ENVS, **skw)
        g = torch.Generator(device=dev).manual_seed(33)
        with torch.no_grad():
            st0, _ = R.batched_reset(m, g, EVAL_ENVS, dev)
            pl0 = mpc.init_batched_plan(m, cfg, EVAL_ENVS, st0)

            def chain(n=1):
                st, pl = st0, pl0
                for _ in range(n):
                    st, pl, _, _ = step(st, pl, g, params)
                return st

            ms, host = _chain_ms(chain, EVAL_TIMED)
            pkw = dict(ik_iters=cfg.preview_ik_iters,
                       solve_iters=cfg.preview_solve_iters)
            roll = fs.make_cuda_rollout(*m, cfg.horizon, with_ee=with_ee,
                                        **pkw)
            XS = fs.pack_state(m.cfg, m.tree, st0)
            XE = XS.repeat_interleave(cfg.pop, 1)
            acts = mpc._sample(g, pl0, cfg, cfg.pop, torch.tensor(
                m.cfg.action_high, device=dev)).reshape(
                    EVAL_ENVS * cfg.pop, cfg.horizon, -1).permute(
                        1, 2, 0).contiguous()
            kE = time_ms(lambda: roll(XE, acts), 5)
            stepk = fs.make_cuda_step(*m)
            kx = time_ms(lambda: stepk(XS, pl0.mean[:, 0].T.contiguous()), 5)
        bE = bound_ms(*work(m, EVAL_ENVS * cfg.pop, cfg.horizon,
                            **pkw)["rollout"])
        say(f"[eval step] {tp.key(env_id)} ({fam} cost) {EVAL_ENVS} envs x "
            f"{cfg.pop} H={cfg.horizon} iters={cfg.iters}: {ms:.3f} ms per "
            f"control step (chain of {EVAL_TIMED}; host enqueue {host:.3f} "
            f"ms); preview rollout kernel B={EVAL_ENVS * cfg.pop}"
            f"{' with_ee' if with_ee else ''} {kE:.3f} ms x {cfg.iters} "
            f"(bound {bE[0]:.4f} ms, {bE[1]}), exec step kernel B="
            f"{EVAL_ENVS} {kx:.3f} ms; rest "
            f"{ms - cfg.iters * kE - kx:.3f} ms; {card()}")
        timed[tp.key(env_id)] = {
            "family_cost": fam, "eval_step_ms": ms, "host_ms": host,
            "preview_kernel_ms": kE, "preview_bound_ms": bE[0],
            "exec_step_kernel_ms": kx}
    record("eval", {"launches": launches, "families": res, "wall_s": wall,
                    "step_ms": timed})
    return launches


LFP_B, LFP_T = 1024, 24          # play collection: envs x steps
LFP_TRAIN, LFP_BATCH, LFP_WINDOW = 200, 256, 16
LFP_HIDDEN = (512, 512)
LFP_EPISODES = 64
LFP_FIELDS = ("obs_quat", "action", "full_positional_state")


def lfp_phase(dev):
    """The learning-from-play chain (tools/collect_play_torch.py,
    tools/train_lfp_torch.py, tools/eval_lfp_torch.py) at full width on
    the flagship, depth cut: LFP_B envs x LFP_T steps of the play actor
    through the step kernel (the reset's settle through the sim kernel),
    the log written and read back bit for bit, LFP_TRAIN Adam steps of the
    512x512 policy on batches of LFP_BATCH windows of LFP_WINDOW, and the
    window-goal eval of LFP_EPISODES episodes, with the launch counts read
    around the collection and the eval. The collection's first step launch
    is held to the plain step per field; the last 20 losses must average
    below the first 20, the policy's forward on the card must equal the
    CPU's with the same parameters within 1e-5 of its scale, and the eval's
    metrics must be finite and whole. The rates are printed, not held."""
    import collect_play_torch as C
    import eval_lfp_torch as EV
    import train_lfp_torch as TR
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.learn import lfp
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    from roboticsplayroompybullet_torch.utils.episodelog import EpisodeReader
    m = core.build_model(CATALOG[FLAGSHIP])
    secs = {}

    def collect():
        t0 = time.perf_counter()
        out = C.collect_play(m, "play", LFP_B, LFP_T,
                             torch.Generator(device=dev).manual_seed(60), dev)
        secs["collect"] = time.perf_counter() - t0
        return out

    with first_calls() as log:
        (obs, acts, cst), launches = counted(collect)
    say(f"[lfp] collect {LFP_B} x {LFP_T} play steps: {secs['collect']:.1f}"
        f" s (reset {cst['reset_s']:.1f} s, steps {cst['steps_s']:.2f} s = "
        f"{LFP_B * LFP_T / cst['steps_s']:.0f} env steps/s, copy "
        f"{cst['copy_s']:.3f} s); launches {launches}; {card()}")
    first = [c for c in log if c["entry"] == "step"
             and c["inputs"][0].shape[1] == LFP_B]
    if launches["step"] != LFP_T or launches["sim"] < 1 or len(first) != 1:
        raise AssertionError(f"lfp collect: launches {launches}")
    X, a = first[0]["inputs"]
    with torch.no_grad():
        Xk = fs.make_cuda_step(*m)(X, a)
        Xp = plain_step(*m)(X, a)
    torch.cuda.synchronize()
    check_fields(f"lfp collect step kernel B={LFP_B} vs plain",
                 field_diffs(m.cfg, m.tree, Xk, Xp))

    path = os.path.join(ROOT, "build", "lfp_smoke", "play.elog")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    fields = C.write_log(path, obs, acts)
    with EpisodeReader(path, fields=list(fields)) as r:
        same = r.n_episodes == LFP_B and all(
            np.array_equal(r.read(b, k), obs[k][:, b] if k in obs
                           else acts[:, b])
            for b in range(LFP_B) for k in fields)
        sampler = lfp.make_memory_sampler(r, fields=LFP_FIELDS)
    secs["log"] = time.perf_counter() - t0
    say(f"[lfp] log {list(fields.items())}: written and read back in "
        f"{secs['log']:.1f} s, bit for bit: {same}")
    if not same:
        raise AssertionError("lfp: the episode log does not read back")

    d = {k: fields[k] for k in LFP_FIELDS}
    with torch.enable_grad():
        policy, losses, secs["train"] = TR.train(
            sampler, tuple(d.values()), TR.action_high(FLAGSHIP,
                                                       d["action"]),
            LFP_TRAIN, LFP_BATCH, LFP_WINDOW, 3e-4, LFP_HIDDEN, 0, dev,
            log_every=0)
    l0, l1 = float(losses[:20].mean()), float(losses[-20:].mean())
    b = sampler(np.random.default_rng(61), LFP_BATCH, LFP_WINDOW)
    with torch.no_grad():
        on_card = policy(torch.tensor(b["obs"], device=dev),
                         torch.tensor(b["goal"], device=dev)).cpu()
        policy_cpu = lfp.GoalConditionedPolicy(
            d["obs_quat"], d["full_positional_state"], d["action"],
            TR.action_high(FLAGSHIP, d["action"]), LFP_HIDDEN)
        policy_cpu.load_state_dict(policy.state_dict())
        on_cpu = policy_cpu(torch.tensor(b["obs"]), torch.tensor(b["goal"]))
    fwd = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    say(f"[lfp] train {LFP_TRAIN} steps {LFP_HIDDEN[0]}x{LFP_HIDDEN[1]}, "
        f"batch {LFP_BATCH} x {LFP_WINDOW}: {secs['train']:.2f} s = "
        f"{LFP_TRAIN / secs['train']:.1f} steps/s; loss {l0:.5f} -> {l1:.5f}"
        f" (first / last 20); forward card vs CPU {fwd:.2e} of its scale "
        f"(<= 1e-5); {card()}")
    if not l1 < l0 or not fwd <= 1e-5:
        raise AssertionError(f"lfp train: loss {l0} -> {l1}, forward {fwd}")

    def evaluate():
        t0 = time.perf_counter()
        out = EV.evaluate(m, policy.eval(), LFP_EPISODES, LFP_WINDOW, 0,
                          device=dev)
        secs["eval"] = time.perf_counter() - t0
        return out

    (res_pol, res_rnd, est), ev_launches = counted(evaluate)
    with open(os.path.join(ROOT, "LFP_EVAL.json")) as f:
        keys = sorted(json.load(f)["policy"])       # the artifact's schema
    say(f"[lfp] eval {LFP_EPISODES} episodes W={LFP_WINDOW}: "
        f"{secs['eval']:.1f} s (reset {est['reset_s']:.1f} s); success "
        f"{res_pol['success_rate_any']:.3f} vs play "
        f"{res_rnd['success_rate_any']:.3f}, final EE "
        f"{res_pol['final_ee_dist_mean_m']:.4f} vs "
        f"{res_rnd['final_ee_dist_mean_m']:.4f} m (not held); launches "
        f"{ev_launches}")
    for res in (res_pol, res_rnd):
        if sorted(res) != keys or not all(np.isfinite(v)
                                          for v in res.values()):
            raise AssertionError(f"lfp eval: {res}")
    if ev_launches["step"] != 3 * LFP_WINDOW or ev_launches["sim"] < 1:
        raise AssertionError(f"lfp eval: launches {ev_launches}")
    launches = {k: launches[k] + ev_launches[k] for k in launches}
    record("lfp", {"launches": launches, "seconds": secs,
                   "collect": cst, "eval": est, "loss_first20": l0,
                   "loss_last20": l1, "forward_card_vs_cpu": fwd,
                   "policy": res_pol, "random": res_rnd})
    return launches


# ---------------------------------------------------------------------------
# the gradient solvers (solver/ilqr.py, solver/gradient.py)
# ---------------------------------------------------------------------------

ILQR_H, ILQR_ITERS = 10, 3       # reach: ilqr_plan's horizon and iterations
PINCH_H, PINCH_ITERS = 3, 2      # the pinch (tests/test_ilqr.py's H)
REFINE_ITERS, REFINE_LR = 2, 0.05    # refine: 2 Adam steps at the default lr
VJP_MAX = 1e-5                   # graphed VJP vs eager, of the grads' scale


@contextlib.contextmanager
def timed_calls(mod, names, secs):
    """While open, mod's functions `names` add the host seconds of each
    call, between two synchronizations, to secs[name] (a list)."""
    saved = {n: getattr(mod, n) for n in names}

    def wrap(n, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs.setdefault(n, []).append(time.perf_counter() - t0)
            return out
        return call

    for n, fn in saved.items():
        setattr(mod, n, wrap(n, fn))
    try:
        yield secs
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


def counted_grad(fn):
    """counted() with autograd on: (fn's result, launch counts, seconds)."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    torch.cuda.synchronize()
    fs.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fs.LAUNCHES), time.perf_counter() - t0


def vjp_check(tag, m, state, base, H, seed):
    """The model's differentiable step at its linearisation width B = H·n,
    at B perturbed copies of `state` (arm joints + 0.02 rad noise, actions
    `base` + 0.1 of the bound in noise, so some sit past it): the VJP
    replayed from the graph the solver captured at another state, against
    the twin's plain (eager) autograd at the same inputs and cotangents,
    within VJP_MAX of the gradients' scale; the step's forward equal to
    the step kernel's. Neither run counts toward the path's launches."""
    from roboticsplayroompybullet_torch.envs import core
    import importlib
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    IL = importlib.import_module("roboticsplayroompybullet_torch.solver.ilqr")
    dev = state.q.device
    x = IL._extract(state)
    n = x.shape[1]
    B, A, n_arm = H * n, m.cfg.action_dim, m.arm.n_arm
    g = torch.Generator(device=dev).manual_seed(seed)
    X = fs.pack_state(m.cfg, m.tree, IL._inject(state, x.expand(B, n)))
    X[:n_arm] += 0.02 * torch.randn((n_arm, B), generator=g, device=dev)
    high = fs.const_on(m.cfg.action_high, dev)
    acts = (base[:, None] + 0.1 * high[:, None] * torch.randn(
        (A, B), generator=g, device=dev)).contiguous()
    gX = torch.randn(X.shape, generator=g, device=dev)
    gC = torch.randn((n_arm + 1, B), generator=g, device=dev)
    step = core._stepper(m)
    vj = step.vjp
    if (dev, B) not in vj.graphs:
        raise AssertionError(f"ilqr {tag}: no graph at B={B} to replay")
    captures = vj.captures

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    g_k, s_rep = timed(lambda: vj(X, acts, gX, gC))
    g_p, s_eager = timed(lambda: vj._vjp(X, acts, gX, gC))
    with torch.no_grad():
        Y, C = step(X, acts)
        Yk, Ck = fs.make_cuda_step(*m, with_ctrl=True)(X, acts)
    same_fwd = bool(torch.equal(Y, Yk) and torch.equal(C, Ck))
    scale = max(float(t.abs().max()) for t in g_p)
    err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p)) / scale
    n_clip = int((acts.abs() > high[:, None]).sum())
    say(f"[ilqr] {tag} VJP B={B} ({n_clip} actions past the bound): graph "
        f"replay {1e3 * s_rep:.1f} ms, the twin's plain autograd (forward "
        f"+ backward) {1e3 * s_eager:.1f} ms; replay vs plain max |d| "
        f"{err:.2e} of the grads' scale {scale:.3g} (<= {VJP_MAX:g}); "
        f"forward == step kernel: {same_fwd}; {card()}")
    if not (err <= VJP_MAX and same_fwd and vj.captures == captures
            and all(bool(torch.isfinite(t).all()) for t in g_p)):
        raise AssertionError(f"ilqr {tag}: differentiable step {err} "
                             f"{same_fwd}")
    return {"B": B, "replay_ms": 1e3 * s_rep, "eager_ms": 1e3 * s_eager,
            "max_rel_err": err, "actions_past_bound": n_clip}


def ilqr_phase(dev):
    """The gradient solvers at full width: every forward pass a step
    launch, the plain twin's VJP (a CUDA graph per model and batch width,
    captured by the solver's first linearisation) in every backward.
    ilqr_plan on UR5Reach (12 substeps, ILQR_H, ILQR_ITERS, zero actions)
    from JAX's reset state (fixture ilqr_reach), refine on UR5Reach
    (fixture ilqr_refine, ILQR_H, REFINE_ITERS), then iLQR through contact
    on pandaPick's scripted pinch (fixture ilqr_pinch; 12 substeps,
    PINCH_H, PINCH_ITERS, the goal-only cost, from the hold plan: d cost /
    d (x0, us) finite, max |d/dus| > 1e-3): each must end finite and
    strictly below its start. Launches are counted around each (H for the
    nominal rollout, H a line search, one at H·n for each linearisation)
    and each iLQR iteration's time is split into linearisation, Riccati
    and line search. After each model's runs, vjp_check holds its graph,
    replayed at states it was not captured at, to the twin's eager
    autograd."""
    import importlib
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.solver.cost import CostWeights
    import _torch_port as tp
    IL = importlib.import_module("roboticsplayroompybullet_torch.solver.ilqr")
    GR = importlib.import_module(
        "roboticsplayroompybullet_torch.solver.gradient")
    out, total = {}, {"sim": 0, "step": 0, "rollout": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def state_of(d):
        return interop.state_from_numpy(
            {f: d[f] for f in interop.FIELDS}, device=dev)

    def plan(tag, m, state, us0, iters, w):
        f = IL.make_flat_dynamics(m, state)
        stage, final = IL.make_stage_cost(m, state, w)
        x0 = IL._extract(state)[0]
        with torch.no_grad():
            _, c0 = IL._rollout_flat(f, stage, final, x0, us0)
        secs = {}
        with timed_calls(IL, ("_linearize", "_riccati", "_line_search"),
                         secs):
            res, launches, s = counted_grad(lambda: IL.ilqr_plan(
                m, state, us0, IL.ILQRConfig(iters=iters), w))
        add(launches)
        H = us0.shape[0]
        want = H + iters * (H + 1)
        c0, c1 = float(c0), float(res.cost)
        ok = (c1 < c0 and launches["step"] == want
              and launches["rollout"] == launches["sim"] == 0
              and all(bool(torch.isfinite(t).all())
                      for t in (res.us, res.xs, res.cost_trace)))
        split = {k: [1e3 * v for v in vs] for k, vs in secs.items()}
        say(f"[ilqr] {tag} H={H} iters={iters}: cost {c0:.5f} -> {c1:.5f} "
            f"(trace {[round(float(c), 5) for c in res.cost_trace]}); "
            f"{s:.1f} s, per iteration ms: linearisation "
            f"{[round(v, 1) for v in split['_linearize']]}, Riccati "
            f"{[round(v, 1) for v in split['_riccati']]}, line search "
            f"{[round(v, 1) for v in split['_line_search']]}; launches "
            f"{launches} (want step {want}); {'ok' if ok else 'FAIL'}; "
            f"{card()}")
        if not ok:
            raise AssertionError(f"ilqr {tag}: {c0} -> {c1}, {launches}")
        return {"c0": c0, "cost": c1, "seconds": s, "launches": launches,
                "ms": split, "trace": [float(c) for c in res.cost_trace]}

    # UR5Reach: the plan's first linearisation (B = ILQR_H·n) warms the
    # twin up and captures its VJP graph; refine replays it
    reach = core.build_model(CATALOG["UR5Reach-v0"])
    s_reach = state_of(tp.load("ilqr_reach"))
    A = reach.cfg.action_dim
    out["reach"] = plan("ilqr_plan UR5Reach", reach, s_reach,
                        torch.zeros((ILQR_H, A), device=dev), ILQR_ITERS,
                        CostWeights())
    s_ref = state_of(tp.load("ilqr_refine"))
    (a, trace), launches, s = counted_grad(lambda: GR.refine(
        reach, s_ref, torch.zeros((ILQR_H, A), device=dev),
        GR.GradConfig(iters=REFINE_ITERS, lr=REFINE_LR)))
    add(launches)
    trace = [float(c) for c in trace]
    want = REFINE_ITERS * (ILQR_H + 1)
    ok = (trace[-1] < trace[0] and bool(torch.isfinite(a).all())
          and launches["step"] == want)
    n_reach = IL._extract(s_reach).shape[1]
    say(f"[ilqr] refine UR5Reach H={ILQR_H} iters={REFINE_ITERS} lr "
        f"{REFINE_LR}: trace {[round(c, 5) for c in trace]}; "
        f"{1e3 * s / REFINE_ITERS:.1f} ms per Adam iteration (rollout-level "
        f"backward: one graphed VJP of {ILQR_H * n_reach} envs); launches "
        f"{launches} (want step {want}); {'ok' if ok else 'FAIL'}; {card()}")
    if not ok:
        raise AssertionError(f"ilqr refine: {trace}, {launches}")
    out["refine"] = {"trace": trace, "ms_per_iter": 1e3 * s / REFINE_ITERS,
                     "launches": launches}
    out["reach_vjp"] = vjp_check("UR5Reach", reach, s_reach,
                                 torch.zeros(A, device=dev), ILQR_H, 71)

    # iLQR through contact: the pinch on the full model; the gradient's
    # linearisation (B = PINCH_H·n) captures pandaPick's graph
    zp = tp.load("ilqr_pinch")
    pick = core.build_model(CATALOG["pandaPick-v0"])
    s_pinch = state_of(zp)
    hold = torch.as_tensor(zp["us0"][0], device=dev)
    us0 = hold.expand(PINCH_H, -1).contiguous()
    w = CostWeights(action=0.0)
    f = IL.make_flat_dynamics(pick, s_pinch)
    stage, final = IL.make_stage_cost(pick, s_pinch, w)
    x0 = IL._extract(s_pinch)[0].clone().requires_grad_()
    u0 = us0.clone().requires_grad_()

    def grad():
        c = IL._rollout_flat(f, stage, final, x0, u0)[1]
        return torch.autograd.grad(c, (x0, u0))

    (gx, gu), launches, s = counted_grad(grad)
    add(launches)
    ok = (bool(torch.isfinite(gx).all() and torch.isfinite(gu).all())
          and float(gu.abs().max()) > 1e-3 and int((gx != 0).sum()) > 0
          and launches["step"] == PINCH_H + 1)
    say(f"[ilqr] pinch d cost / d (x0, us) through contact, pandaPick "
        f"{pick.cfg.substeps} substeps H={PINCH_H}: {s:.1f} s (the first "
        f"linearisation at B={PINCH_H * x0.shape[0]}: warm-up and capture), "
        f"max |d/dus| {float(gu.abs().max()):.4g} (> 1e-3), "
        f"{int((gx != 0).sum())} nonzero d/dx0; launches {launches}; "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ilqr pinch: dead or non-finite gradient")
    out["pinch"] = plan("ilqr_plan pinch pandaPick", pick, s_pinch, us0,
                        PINCH_ITERS, w)
    out["pinch"]["grad_s"] = s
    out["pinch_vjp"] = vjp_check("pinch pandaPick", pick, s_pinch, hold,
                                 PINCH_H, 72)

    out["graphs"] = {k: {"eager": v.vjp.eager, "captures": v.vjp.captures,
                         "replays": v.vjp.replays}
                     for k, v in (("UR5Reach", core._stepper(reach)),
                                  ("pandaPick", core._stepper(pick)))}
    say(f"[ilqr] the twin's VJP on the card: {out['graphs']} (no eager "
        "backward on the solvers' path; one capture a model at its "
        "linearisation width)")
    if any(v != {"eager": 0, "captures": 1, "replays": v["replays"]}
           for v in out["graphs"].values()):
        raise AssertionError(f"ilqr: graphs {out['graphs']}")
    record("ilqr", out)
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()
    smi = device_phase()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                    os.path.join(ROOT, "tools")]
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG

    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    secs = record("phase_s", {})

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        free_graphs()
        secs[name] = time.perf_counter() - t0
        say(f"[{name}] phase took {secs[name]:.1f} s")
        return out

    m = core.build_model(CATALOG[FLAGSHIP])
    # nvcc runs beside the twin phase's plain calls, which need no kernel;
    # leaving the block waits for it, after a failure too
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(build_phase)
        errs, twin_inputs, plain_first = run("build + twin", twin_phase, m,
                                             dev, build.result)
    run("jax parity", jax_parity_phase, dev)
    states, acts = main_path_inputs(m, dev)
    launches, kernel_out = run("main path", main_path_phase, m, dev, states,
                               acts)
    run("horizon twin", horizon_twin_phase, m, dev, states, acts, kernel_out)
    times = run("timing", timing_phase, m, dev, twin_inputs, plain_first)
    run("preview", preview_phase, dev)
    run("mpc twin", mpc_twin_phase, dev)
    p = mpc_path_inputs(dev)
    mpc_launches, mpc_calls = run("mpc path", mpc_path_phase, dev, p)
    run("mpc shapes", mpc_shapes_phase, mpc_calls)
    run("mpc timing", mpc_timing_phase, dev, p)
    multi_launches = run("multi", multi_phase, dev, m, states, acts,
                         kernel_out, p)
    env_launches = {"multi": multi_launches}
    for name, phase in (("env step", env_step_phase),
                        ("render", render_phase),
                        ("env reset", env_reset_phase),
                        ("mpc plan loop", plan_loop_phase),
                        ("env golden", env_golden_phase),
                        ("eval", eval_phase),
                        ("lfp", lfp_phase),
                        ("ilqr", ilqr_phase)):
        env_launches[name] = run(name, phase, dev)
    say(f"[phases] {sum(secs.values()):.1f} s in all: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))

    # the bound of each kernel at the shape it was timed at (B=4096, the
    # rollout at H=2); no single PyTorch call computes the fused step
    bounds = {k: bound_ms(*w) for k, w in work(m, 4096, 2).items()}
    main_bound = bound_ms(*work(m, 4096, 40)["rollout"])
    for k, (b_ms, by) in bounds.items():
        say(f"[bound] {k}: {b_ms:.4f} ms ({by}), kernel {times[k][0]:.3f} ms:"
            f" {100 * b_ms / times[k][0]:.2f} % of the bound")
    say(f"[bound] main path rollout H=40 B=4096: {main_bound[0]:.4f} ms "
        f"({main_bound[1]}), {100 * main_bound[0] / RESULTS['main_path']['ms']:.2f}"
        " % of it")
    record("bounds", {k: {"ms": v[0], "by": v[1]} for k, v in bounds.items()})
    # launches: the runs of the main path, the MPC path and the env paths
    by_path = dict({"main": launches, "mpc": mpc_launches}, **env_launches)
    kernels = [{"name": f"fused_step.{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k],
                "launches": sum(v[k] for v in by_path.values()),
                "launches_by_path": {p_: v[k] for p_, v in by_path.items()},
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": None}
               for k in ("sim", "step", "rollout")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(RESULTS, kernels=kernels), f, indent=1,
                      default=float)      # numpy scalars
    say(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

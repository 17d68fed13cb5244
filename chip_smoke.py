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
Every phase prints its numbers; any failure raises and the
script exits non-zero without a result line. About 14 minutes on one
H100, most of it the plain twin's eager steps (the H=40 check takes 40,
the H=10 previews 20).

The last two lines are one JSON object per kernel ({"kernels": [...]};
`launches` adds the main path's and the MPC path's counts), then
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
    """(FLOPs, bytes) of each kernel's call on the main path's shapes: sim
    (B envs, 12 substeps), step (control + 12 substeps) and rollout (H
    steps + ags), counted per phase from the source and this model's
    static row table, link types and ancestors (PERF.md §6 gives the
    per-phase formulas). Each input byte is read once, each output byte
    written once."""
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
    return {"sim": (B * sim, f4 * B * (2 * nf + na + 1)),
            "step": (B * (control + sim), f4 * B * (2 * nf + A)),
            "rollout": (B * H * (control + sim + 4),
                        f4 * B * (2 * nf + H * (A + ag)))}


def bound_ms(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
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


def twin_phase(m, dev):
    """Kernel vs plain PyTorch twin on the card, per field, at the main
    path's batch (B=4096; the rollout at H=2). Returns each kernel's max
    error, the inputs, and the device ms of each plain call (the first
    plain time of timing_phase's pairs)."""
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

    with torch.no_grad():
        k = fs.make_cuda_sim(*m)(X, ctrl, grip)
        p = timed("sim", lambda: fs.make_reference_sim(*m)(X, ctrl, grip))
    torch.cuda.synchronize()
    err = {"sim": check_fields(f"twin sim 12 substeps B={B}",
                               field_diffs(cfg, tree, k, p))}

    rs = np.random.RandomState(2)
    H = 2
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (H, cfg.action_dim, B)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        step_k = fs.make_cuda_step(*m)
        ks = step_k(X, acts[0])
        ps = timed("step", lambda: fs.make_reference_step(*m)(X, acts[0]))
        err["step"] = check_fields(f"twin step B={B}",
                                   field_diffs(cfg, tree, ks, ps))
        kr, kag = fs.make_cuda_rollout(*m, horizon=H)(X, acts)
        pr, pag = timed("rollout", lambda: fs.make_reference_rollout(
            *m, horizon=H)(X, acts))
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
    step_p = fs.make_reference_step(*m)
    ag_of = fs.make_lane_ag(cfg, tree, m.arm)
    pos_rows = position_rows(cfg, tree, dev)
    bad, per_step = [], []
    with torch.no_grad():
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
    """Each kernel and its plain version at B=4096 (rollout at H=2) on the
    twin phase's inputs, in turns: plain (the twin phase's check call),
    kernel, kernel, plain (one cold call: the plain twin is host-bound, its
    first call costs what a later one does); the rollout kernel's batch
    scaling at H=40 and its split into Jacobi sweeps / IK / the rest."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    B, H = 4096, 2
    X, ctrl, grip, acts = inputs
    rs = np.random.RandomState(6)
    pairs = {
        "sim": (lambda f=fs.make_cuda_sim(*m): f(X, ctrl, grip),
                lambda f=fs.make_reference_sim(*m): f(X, ctrl, grip)),
        "step": (lambda f=fs.make_cuda_step(*m): f(X, acts[0]),
                 lambda f=fs.make_reference_step(*m): f(X, acts[0])),
        "rollout": (lambda f=fs.make_cuda_rollout(*m, horizon=H): f(X, acts),
                    lambda f=fs.make_reference_rollout(*m, horizon=H):
                    f(X, acts)),
    }
    out = {}
    with torch.no_grad():
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain; the mean of each pair
            p1 = plain_first[name]
            k1 = time_ms(kern, 3)
            k2 = time_ms(kern, 3)
            p2 = time_ms(plain, 1, warm=False)
            out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            say(f"[timing] {name} B={B}{' H=2' if name == 'rollout' else ''}"
                f": kernel {out[name][0]:.3f} ms ({k1:.3f}, {k2:.3f}), "
                f"plain {out[name][1]:.1f} ms ({p1:.1f}, {p2:.1f})")
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
            pr, pag = fs.make_reference_rollout(*m, **kw)(X, acts)
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
        ref = fs.make_reference_rollout(*m, **kw)
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
    with torch.no_grad():
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
    makes passes its calls through unchanged (the launch counts are its
    own) and keeps its first call: yields the list of {entry, m, args, kw,
    inputs} it appends to, one per wrapper, in the order of first calls."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    log, made = [], (fs.make_cuda_step, fs.make_cuda_rollout)

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
    try:
        yield log
    finally:
        fs.make_cuda_step, fs.make_cuda_rollout = made


def preview_horizon_check(m, kw, parts):
    """parts: [(tag, X0 (NF, B), actions (H, A, B), with_ee)] of one model at
    one fidelity kw (n_substeps, ik_iters, solve_iters), each through the
    rollout kernel and held step by step as horizon_twin_phase holds the
    H=40 rollout: the rollout kernel equals H step-kernel launches of the
    same fidelity (state and ags, the latter against the plain ag of each
    step's state, within 1e-5), and at every step the plain step from the
    kernel's state agrees with the kernel's next state (each field's p99
    within the one-step bounds, positions within ROLLOUT_MAX). An env
    outside the one-step bounds is stepped again by the plain twin in
    float64, and counts against the kernel only where the kernel is
    farther from that step than the float32 plain step is (env_error): at
    most MAX_FLIPS such envs a part and step. A population is a few start
    states times many candidates, so an env near a branch (contact,
    clamp) brings its candidates with it. The plain steps of all parts run
    as one call a step."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    cfg, tree = m.cfg, m.tree
    step_k = fs.make_cuda_step(*m, **kw)
    step_p = fs.make_reference_step(*m, **kw)
    pos_rows = position_rows(cfg, tree, parts[0][1].device)
    H = parts[0][2].shape[0]
    Bs = [X.shape[1] for _, X, _, _ in parts]
    ag_of = [fs.make_lane_ag(cfg, tree, m.arm, ee) for *_, ee in parts]
    worst = [dict(flips=0, against=0, ags=0.0, fields={}) for _ in parts]
    bad, outside = [], []
    with torch.no_grad():
        runs = [fs.make_cuda_rollout(*m, H, with_ee=ee, **kw)(X, a)
                for _, X, a, ee in parts]
        Xk = [X for _, X, _, _ in parts]
        for h in range(H):
            Xin = list(Xk)
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
                if over or pmax >= ROLLOUT_MAX:
                    bad.append((tag, h + 1, over, pmax))
                flagged.append(torch.nonzero(
                    env_error(Xk[j], Y[j], pos_rows) > 1).flatten())
            if sum(len(f) for f in flagged):
                cat = lambda xs: torch.cat(  # noqa: E731
                    [x[:, f] for x, f in zip(xs, flagged)], 1)
                Y64 = step_p(cat(Xin).double(), cat(
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
            "rollout_vs_steps": {"state_max": w["state"],
                                 "ags_max": w["ags"]}})
        if w["state"] > 1e-5 or w["ags"] > 1e-5:
            fails.append(f"{tag}: rollout kernel != {H} step-kernel launches")
    if bad:
        fails.append("steps outside the bounds (tag, step, fields, position"
                     f" max) or (tag, step, envs against the kernel): {bad}")
    if fails:
        raise AssertionError("; ".join(fails))


def mpc_shapes_phase(calls):
    """The MPC path's kernels held at the path's own shapes, on its own
    inputs (the first call of each kernel wrapper in mpc_path_phase,
    `calls` {piece: first_calls log}): the preview rollouts (H=10, ik 8 /
    solve 8: the flagship replan's B=1024 and the eval step's B=4096
    with_ee in one plain call a step, the UR5Reach closed loop's B=1024)
    by preview_horizon_check, and the executed steps (the eval step's B=4,
    the closed loop's B=1) against the plain step at the twin bounds."""
    from roboticsplayroompybullet_torch.envs.core import EnvModel
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    fid = ("n_substeps", "ik_iters", "solve_iters")
    groups = {}
    for piece, log in calls.items():
        for c in log:
            X, a = c["inputs"]
            kw = {k: c["kw"].get(k) for k in fid if k in c["kw"]}
            tag = (f"mpc path {piece} {c['entry']} kernel B={X.shape[1]}"
                   + (f" H={a.shape[0]} ik {kw.get('ik_iters')} solve "
                      f"{kw.get('solve_iters')}"
                      + (" with_ee" if c["kw"].get("with_ee") else "")
                      if c["entry"] == "rollout" else ""))
            if c["entry"] == "step":
                with torch.no_grad():
                    k = fs.make_cuda_step(*c["m"], **kw)(X, a)
                    p = fs.make_reference_step(*c["m"], **kw)(X, a)
                torch.cuda.synchronize()
                check_fields(tag, field_diffs(c["m"][0], c["m"][1], k, p))
                say(f"[{tag}] {card()}")
                continue
            key = (id(c["m"][0]), tuple(sorted(kw.items())))
            groups.setdefault(key, (c["m"], kw, []))[2].append(
                (tag, X, a, bool(c["kw"].get("with_ee"))))
    for m, kw, parts in groups.values():
        preview_horizon_check(EnvModel(*m), kw, parts)


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
    build_phase()
    m = core.build_model(CATALOG[FLAGSHIP])
    errs, twin_inputs, plain_first = twin_phase(m, dev)
    jax_parity_phase(dev)
    states, acts = main_path_inputs(m, dev)
    launches, kernel_out = main_path_phase(m, dev, states, acts)
    horizon_twin_phase(m, dev, states, acts, kernel_out)
    times = timing_phase(m, dev, twin_inputs, plain_first)
    preview_phase(dev)
    mpc_twin_phase(dev)
    p = mpc_path_inputs(dev)
    mpc_launches, mpc_calls = mpc_path_phase(dev, p)
    mpc_shapes_phase(mpc_calls)
    mpc_timing_phase(dev, p)

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
    # launches: the main path's run plus the MPC path's run
    kernels = [{"name": f"fused_step.{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k],
                "launches": launches[k] + mpc_launches[k],
                "launches_by_path": {"main": launches[k],
                                     "mpc": mpc_launches[k]},
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": None}
               for k in ("sim", "step", "rollout")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(RESULTS, kernels=kernels), f, indent=1)
    say(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

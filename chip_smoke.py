"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Builds the hand-written CUDA kernel (roboticsplayroompybullet_torch/csrc/
fused_step.cu) from this checkout, holds each of its three entry points
(sim, step, rollout) to the plain PyTorch lane twin on the card and to the
JAX package's outputs (committed fixtures, tests/torch_fixtures/), then
drives the port's main path — make_fused_rollout_whole(m, 40) on
UR5PlayAbsRPY1Obj-v0 at B=4096, plus the env step and the sim kernel —
holds its rollout to the plain twin at that same shape, and times it with
CUDA events. Every phase prints its numbers; any failure raises and the
script exits non-zero without a result line. About 10 minutes on one
H100, most of it the plain twin's eager steps (the H=40 check takes 40).

The last two lines are one JSON object per kernel ({"kernels": [...]}),
then {"ok": true, "device": {...}}. There is no CPU mode: without a CUDA
card the script exits with code 2.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
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
RESULTS = {}


def say(*parts):
    print(*parts, flush=True)


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


def build_phase():
    from roboticsplayroompybullet_torch.ops import cuda_build
    t0 = time.time()
    cuda_build.build(force=True)
    cuda_build.library()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in cuda_build.BUILD_INFO.get("log", "")
             .splitlines() if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    say(f"[build] nvcc sm_90a: {secs:.1f} s")
    for ln in ptxas:
        say("[build]   " + ln)
    record("build_s", secs)
    record("ptxas", ptxas)


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


def time_ms(fn, reps):
    """Mean device ms per call over `reps` calls, after one warm-up call."""
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
    path's batch (B=4096; the rollout at H=2)."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    cfg, tree = m.cfg, m.tree
    B = 4096
    st = flagship_states(B, dev, seed=1)
    X = fs.pack_state(cfg, tree, st)
    ctrl = st.ctrl_q.T.contiguous()
    grip = st.grip.contiguous()
    with torch.no_grad():
        k = fs.make_cuda_sim(*m)(X, ctrl, grip)
        p = fs.make_reference_sim(*m)(X, ctrl, grip)
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
        ps = fs.make_reference_step(*m)(X, acts[0])
        torch.cuda.synchronize()
        err["step"] = check_fields(f"twin step B={B}",
                                   field_diffs(cfg, tree, ks, ps))
        kr, kag = fs.make_cuda_rollout(*m, horizon=H)(X, acts)
        pr, pag = fs.make_reference_rollout(*m, horizon=H)(X, acts)
        torch.cuda.synchronize()
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
    return err


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
    rows, _ = fs._field_rows(cfg, tree)
    pos_rows = torch.tensor([n in POSITION_FIELDS for n, r in rows
                             for _ in range(r)], device=dev)
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
            diffs = field_diffs(cfg, tree, Xk, Yt)
            d = (Xk - Yt).abs()
            flips = int(((d > POS_MAX) & pos_rows[:, None]
                         | (d > VEL_MAX) & ~pos_rows[:, None]).any(0).sum())
            pmax = max(v[0] for k, v in diffs.items() if k in POSITION_FIELDS)
            over = [k for k, (_, p99) in diffs.items()
                    if p99 > (POS_MAX if k in POSITION_FIELDS else VEL_P99)]
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


def timing_phase(m, dev):
    """Each kernel and its plain version at B=4096 (rollout at H=2)."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    B, H = 4096, 2
    st = flagship_states(B, dev, seed=5)
    X = fs.pack_state(m.cfg, m.tree, st)
    ctrl, grip = st.ctrl_q.T.contiguous(), st.grip.contiguous()
    rs = np.random.RandomState(6)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (H, m.cfg.action_dim, B)),
                        dtype=torch.float32, device=dev)
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
            p1 = time_ms(plain, 1)
            k1 = time_ms(kern, 3)
            k2 = time_ms(kern, 3)
            p2 = time_ms(plain, 1)
            out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            say(f"[timing] {name} B={B}{' H=2' if name == 'rollout' else ''}"
                f": kernel {out[name][0]:.3f} ms ({k1:.3f}, {k2:.3f}), "
                f"plain {out[name][1]:.1f} ms ({p1:.1f}, {p2:.1f})")
    record("timing_ms", {k: {"kernel": v[0], "plain": v[1]}
                         for k, v in out.items()})

    # how the whole-horizon kernel scales with the batch (one thread per
    # env, 128 a block: B=4096 fills 32 of the card's SMs)
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
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()
    smi = device_phase()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG

    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    build_phase()
    m = core.build_model(CATALOG[FLAGSHIP])
    errs = twin_phase(m, dev)
    jax_parity_phase(dev)
    states, acts = main_path_inputs(m, dev)
    launches, kernel_out = main_path_phase(m, dev, states, acts)
    horizon_twin_phase(m, dev, states, acts, kernel_out)
    times = timing_phase(m, dev)

    kernels = [{"name": f"fused_step.{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in ("sim", "step", "rollout")]
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

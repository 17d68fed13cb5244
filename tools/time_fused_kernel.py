"""Time the port's fused rollout kernel on the card: the whole-horizon
rollout at the main path's shape, its split into Jacobi sweeps / IK / the
rest, and, given a second copy of the kernel source, the two side by side.

    python3 tools/time_fused_kernel.py [--source OTHER.cu] [--B 4096]
        [--H 40] [--out timing.json]

Each source is built with nvcc into its own library (ops/cuda_build.py) and
launched through the same Model packing, so two versions of
csrc/fused_step.cu (for instance the one of an earlier commit, unpacked
into a gitignored directory) are compared on the same inputs in one
process, in turns: A, B, B, A. The split times the same rollout at
solve_iters 0 and ik_iters 0 beside the full 8 / 24 (bench.py's method,
with 0 instead of 1): the difference to the full run is the sweeps' or
the IK's share; the rest is FK, ABA, contact gathering, effective masses,
the warm-start sweep and integration. CUDA events, after one warm-up call.
Needs a CUDA card; prints `nvidia-smi`'s name and power limit first.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "UR5PlayAbsRPY1Obj-v0"


def rollout_fn(m, H, source, ik_iters=None, solve_iters=8):
    """roll(X (NF, B), acts (H, A, B)) → (X', ags) through `source`."""
    from roboticsplayroompybullet_torch.ops import cuda_build
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    km = cuda_build.KernelModel(
        *m, n_substeps=m.cfg.substeps,
        ik_iters=fs.default_ik_iters(m.arm) if ik_iters is None else ik_iters,
        solve_iters=solve_iters, source=source)
    _, ag_dim = fs.ag_layout(m.cfg, m.tree)

    def roll(X, acts):
        B = X.shape[1]
        out = torch.empty_like(X)
        ags = torch.empty((H, ag_dim, B), dtype=torch.float32,
                          device=X.device)
        km.launch("rollout", X.device, B, X, acts, out, ags, H)
        return out, ags

    return roll


def flagship_inputs(m, B, H, dev, seed=3):
    """chip_smoke.py's flagship states at B, packed, and uniform(-0.25,
    0.25) actions (H, A, B) from a numpy seed."""
    import chip_smoke
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    X = fs.pack_state(m.cfg, m.tree, chip_smoke.flagship_states(B, dev, seed))
    rs = np.random.RandomState(seed + 1)
    acts = torch.tensor(rs.uniform(-0.25, 0.25, (H, m.cfg.action_dim, B)),
                        dtype=torch.float32, device=dev)
    return X, acts


def phase_split(m, H, source, X, acts, reps=2):
    """{full, no_sweeps, no_ik: ms; sweeps, ik, rest: share of full}."""
    from chip_smoke import time_ms
    ms = {}
    with torch.no_grad():
        for key, kw in (("full", {}), ("no_sweeps", {"solve_iters": 0}),
                        ("no_ik", {"ik_iters": 0})):
            roll = rollout_fn(m, H, source, **kw)
            ms[key] = time_ms(lambda: roll(X, acts), reps)
    full = ms["full"]
    sweeps = max(0.0, full - ms["no_sweeps"]) / full
    ik = max(0.0, full - ms["no_ik"]) / full
    return dict(ms, sweeps=sweeps, ik=ik, rest=max(0.0, 1 - sweeps - ik))


PHASES = ("io", "control", "ik", "aba", "servo", "context", "gather",
          "kdir", "warm", "sweeps", "integrate", "ag")


def profile(m, H, X, acts):
    """One rollout of a copy of the package's source built with FS_PROFILE:
    {phase: share of the clocks lane 0 of every env spent in it}."""
    import ctypes
    from roboticsplayroompybullet_torch.ops import cuda_build
    src = os.path.join(cuda_build.BUILD_DIR, "fused_step_profile.cu")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with open(cuda_build.SOURCE) as f, open(src, "w") as g:
        g.write("#define FS_PROFILE\n" + f.read())
    cuda_build.build(force=True, source=src)
    lib = cuda_build.library(src)
    counts = (ctypes.c_ulonglong * len(PHASES))()
    roll = rollout_fn(m, H, src)
    with torch.no_grad():
        roll(X, acts)
        torch.cuda.synchronize()
        lib.fs_profile_read(counts)          # zero after the warm-up
        roll(X, acts)
        torch.cuda.synchronize()
    if lib.fs_profile_read(counts) != 0:
        raise RuntimeError("fs_profile_read failed")
    tot = float(sum(counts))
    return {p: counts[i] / tot for i, p in enumerate(PHASES)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another kernel source (repeatable); with one, it "
                    "is timed in turns with the package's")
    ap.add_argument("--profile", action="store_true",
                    help="also build the package's source with FS_PROFILE "
                    "and print each phase's share of the SM clocks")
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--H", type=int, default=40)
    ap.add_argument("--out", help="write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from chip_smoke import time_ms
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    m = core.build_model(CATALOG[FLAGSHIP])
    X, acts = flagship_inputs(m, args.B, args.H, dev)
    sources = {"package": cuda_build.SOURCE}
    for i, src in enumerate(args.source):
        sources["other" if len(args.source) == 1 else
                os.path.basename(src)] = os.path.abspath(src)
    res = {"nvidia_smi": smi, "B": args.B, "H": args.H, "sources": sources,
           "build": {}, "split": {}, "turns": []}
    with ThreadPoolExecutor(len(sources)) as ex:   # one nvcc per source
        logs = dict(zip(sources, ex.map(
            lambda s: cuda_build.build(force=True, source=s), sources.values())))
    for name, src in sources.items():
        cuda_build.library(src)
        with open(os.path.splitext(logs[name])[0] + ".log") as f:
            res["build"][name] = [ln.strip() for ln in f if "registers" in ln
                                  or "stack frame" in ln]
        for ln in res["build"][name]:
            print(f"[build {name}] {ln}", flush=True)
    for name, src in sources.items():
        sp = phase_split(m, args.H, src, X, acts)
        res["split"][name] = sp
        print(f"[split {name}] B={args.B} H={args.H}: full {sp['full']:.3f} "
              f"ms, solve_iters=0 {sp['no_sweeps']:.3f} ms, ik_iters=0 "
              f"{sp['no_ik']:.3f} ms -> sweeps {sp['sweeps']:.3f}, IK "
              f"{sp['ik']:.3f}, rest {sp['rest']:.3f}", flush=True)
    if args.profile:
        res["profile"] = profile(m, args.H, X, acts)
        print("[profile] share of SM clocks: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["profile"].items()), flush=True)
    if len(args.source) == 1:
        rolls = {n: rollout_fn(m, args.H, s) for n, s in sources.items()}
        order = ["other", "package", "package", "other"]
        with torch.no_grad():
            outs = {n: r(X, acts) for n, r in rolls.items()}
            for n in order:
                ms = time_ms(lambda: rolls[n](X, acts), 2)
                res["turns"].append((n, ms))
                print(f"[turns] {n}: {ms:.3f} ms per H={args.H} rollout, "
                      f"{args.B / (ms / 1e3):.1f} rollouts/s", flush=True)
        torch.cuda.synchronize()
        dx = float((outs["package"][0] - outs["other"][0]).abs().max())
        dag = float((outs["package"][1] - outs["other"][1]).abs().max())
        res["package_vs_other"] = {"state_max": dx, "ags_max": dag}
        print(f"[turns] package vs other: state max {dx:.3e}, ags max "
              f"{dag:.3e} (free-running H={args.H}; see PERF.md)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()

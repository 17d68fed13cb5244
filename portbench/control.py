"""The readings that the limits of `correct` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--control64-seeds ...] [--fault-seeds ...] \
        --seconds 2 [--out file.jsonl]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, then its comparison with the plain reference, as a run
makes it (the program's readings, the lower end of each limit). For each
control seed also the control: the reference computed one precision below
its own (float32 as bfloat16, float64 as float32; reference/lowp.py) put in
the program's place and compared the same way (the upper end). A control64
seed reads the reference with its float64 control alone in float32. A
fault seed of an MPC cell reads the reference with its MPPI update taken
over the first half of the population, in the program's place. One JSON
line a reading. The benchmark's own runs do not run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def half_population():
    """The reference's MPPI update over the first half of the population:
    the fault of a mean taken over half the batch."""
    from portbench.reference import mppi
    update = mppi.mppi_update

    def half(cfg, actions, costs):
        n = costs.shape[-1] // 2
        return update(cfg, actions[..., :n, :, :], costs[..., :n])
    mppi.mppi_update = half
    try:
        yield
    finally:
        mppi.mppi_update = update


def readings(workload, seed, seconds, control, device, overrides=None,
             plains=None, control64=False, fault=False):
    """[(kind, numbers, gaps, seconds of reference)] of one seed:
    ("program", ...) and, with control, ("control", ...), with control64
    ("control64", ...), with fault ("fault_half", ...); gaps are readings
    behind the numbers that are not compared. `plains` {lower: Plain}
    keeps the reference's CUDA graphs from one seed to the next."""
    from portbench.reference.plain import Plain
    plains = {} if plains is None else plains
    wl = harness.load_workload(workload)
    cell = harness.Cell(workload, wl, harness.load_config(wl["config"]),
                        seed, device, harness.Spans(), overrides)
    driver = harness.load_module("traffic", wl["driver"]).Driver(cell)
    driver.setup()
    driver.window(seconds)
    inputs, got = driver.sample()
    t0 = time.perf_counter()
    def plain(lower):
        if lower not in plains:
            plains[lower] = Plain(driver.ref_model, lower=lower)
        return plains[lower]

    ref = driver.reference(inputs, plain=plain(False))
    gaps = getattr(driver, "gaps", lambda got, ref: {})
    out = [("program", driver.numbers(got, ref), gaps(got, ref),
            time.perf_counter() - t0)]
    wrong = []
    if fault:
        wrong.append(("fault_half", False, half_population))
    if control64:
        wrong.append(("control64", "float64", contextlib.nullcontext))
    if control:
        wrong.append(("control", True, contextlib.nullcontext))
    for kind, lower, ctx in wrong:
        t0 = time.perf_counter()
        with ctx():
            low = driver.reference(inputs, plain=plain(lower))
        out.append((kind, driver.numbers(low, ref), gaps(low, ref),
                    time.perf_counter() - t0))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control64-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    plains = {}
    try:
        for seed in args.seeds:
            for kind, nums, gaps, secs in readings(
                    args.workload, seed, args.seconds,
                    seed in args.control_seeds, dev, plains=plains,
                    control64=seed in args.control64_seeds,
                    fault=seed in args.fault_seeds):
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "kind": kind, "reference_s": secs,
                                   "numbers": nums, "gaps": gaps})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""portbench's harness: finds a cell's files by name, checks the card, runs
the cell's traffic driver, reads the per-layer metrics and prints the result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is `portbench/workloads/<cell>.json`: its configuration (a file
`portbench/configs/<config>.json`), its traffic driver
(`portbench/traffic/<driver>.py`), the driver's parameters and the limits
of the comparison that decides `correct`. A per-layer metric is a reader
`portbench/metrics/<metric>.py`. Nothing here names a cell, a
configuration or a metric: adding one is adding files.

With `--trace 0` the run measures its window for `--seconds` and prints
the cell's end-to-end metrics; with `--trace 1` it measures a traced window
of the workload's `trace_seconds` under torch.profiler and prints the
per-layer metrics, `busy_s` / `window_s` and a breakdown. Either way it
then checks the window's outputs against the plain reference
(portbench/reference) and prints each compared number beside its limit.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "roboticsplayroompybullet_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "roboticsplayroompybullet_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class Refused(Exception):
    """The run cannot measure: it prints no result and exits non-zero."""

    def __init__(self, msg, code=2):
        super().__init__(msg)
        self.code = code


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise Refused(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise Refused(f"no {kind} file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_workload(name: str) -> dict:
    return _json("workloads", name)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    if not NAME.match(name):
        raise Refused(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise Refused(f"no {kind} file {os.path.relpath(path, ROOT)}")
    importlib.import_module(f"portbench.{kind}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def available(kind: str):
    """Names of every file of portbench/<kind>/ with its extension."""
    ext = ".py" if kind in ("traffic", "metrics") else ".json"
    d = os.path.join(HERE, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def benchmark_entries(cell: str):
    """(end-to-end names, per-layer names) that BENCHMARK.json gives this
    cell."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise Refused("no BENCHMARK.json beside portbench/")
    with open(path) as f:
        bench = json.load(f)

    def mine(entries):
        return [e["name"] for e in entries
                if "workloads" not in e or cell in e["workloads"]]

    return mine(bench.get("end_to_end", [])), mine(bench.get("per_layer", []))


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Spans:
    """Host spans around the harness's calls into each layer: (name, start,
    end) by time.perf_counter, kept in memory. While a trace runs, each is
    also a torch.profiler annotation of the same name."""

    def __init__(self):
        self.records = []
        self.annotate = False

    def span(self, name):
        return _Span(self, name)


class _Span:
    __slots__ = ("owner", "name", "t0", "rf")

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.rf = None
        if self.owner.annotate:
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.records.append((self.name, self.t0, t1))
        return False


class Cell:
    """What a traffic driver is handed: the cell's name, its workload and
    configuration files, the seed, the device and the spans."""

    def __init__(self, name, workload, config, seed, device, spans,
                 overrides=None):
        self.name = name
        self.workload = workload
        self.config = config
        self.seed = seed
        self.device = device
        self.spans = spans
        self.params = dict(workload.get("params", {}), **(overrides or {}))
        self.limits = dict(workload.get("limits", {}))


def judge(checks, limits):
    """checks {name: value} against limits {name: limit}: (ok, lines). A
    value that is not a finite number, or above its limit, fails; a number
    without a limit fails too."""
    ok, out = True, {}
    for name, value in checks.items():
        lim = limits.get(name)
        good = (lim is not None and isinstance(value, (int, float))
                and math.isfinite(value) and value <= lim)
        ok = ok and good
        if isinstance(value, float) and not math.isfinite(value):
            value = str(value)          # JSON has no NaN or infinity
        out[name] = {"value": value, "limit": lim}
    return ok, out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, t_start, device=None, overrides=None, require_card=True):
    """One run of a cell; returns the result line as a dict (the last key,
    "checks", holds each compared number beside its limit)."""
    workload = load_workload(args.workload)
    config = load_config(workload["config"])
    chips = int(workload.get("chips", 1))
    import torch
    if require_card:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the port runs only on the card")
        if torch.cuda.device_count() < chips:
            raise Refused(f"{args.workload} needs {chips} cards, "
                          f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
    t_torch = time.perf_counter()
    try:
        importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Refused(f"the program {PROGRAM} is not importable: {e}", 3)
    t_program = time.perf_counter()
    spans = Spans()
    cell = Cell(args.workload, workload, config, args.seed, device, spans,
                overrides)
    driver = load_module("traffic", workload["driver"]).Driver(cell)

    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.2f} s: torch and the card "
          f"{t_torch - t_start:.2f} s, the program {t_program - t_torch:.2f} "
          f"s, the cell {t_start + setup_s - t_program:.2f} s",
          file=sys.stderr)
    e2e_names, layer_names = benchmark_entries(args.workload)
    line = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
            "device": {}}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if args.trace:
        from . import trace as tr
        seconds = min(args.seconds, float(workload.get("trace_seconds",
                                                       args.seconds)))
        window, prof = tr.traced(driver, seconds, spans, device)
        info = tr.read(prof, {n for n, _, _ in spans.records})
        metrics = {}
        for name in layer_names:
            reader = load_module("metrics", name)
            got = reader.read(info, cell, window)
            if got is not None:
                metrics[name] = {"value": got, "unit": reader.UNIT}
        line["breakdown"] = info.breakdown()
    else:
        window = driver.window(args.seconds)
        metrics = {}
        for name, (value, unit) in window["metrics"].items():
            if name in e2e_names:
                metrics[name] = {"value": value, "unit": unit}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    line["attempted"] = window["attempted"]
    line["failed"] = window["failed"]
    line["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if args.trace:
        dev["busy_s"] = info.busy_s
        dev["window_s"] = info.window_s
    line["device"] = dev
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"portbench: the comparison with the reference took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    bad = forbidden_loaded()
    if bad:
        raise Refused(f"modules loaded in the run: {bad}", 4)
    ok, line["checks"] = judge(checks, cell.limits)
    line["correct"] = ok and window["failed"] == 0
    return line


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        line = run(args, t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    print(f"correct {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

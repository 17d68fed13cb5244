"""The traced window: the driver's window under torch.profiler (CPU and
CUDA activities), and what the per-layer readers read from it.

The window is the harness's "window" annotation: it opens after a
synchronize and closes after the window's last synchronize, so every
device operation the window caused lies inside it. Device events are the
profiler's CUDA activities (kernels, copies, sets); `busy_s` is the length
of their union inside the window.
"""
from __future__ import annotations

import re

import torch

_KERNEL = re.compile(r"\bfs_(\w+?)_kernel\b")


def traced(driver, seconds, spans, device):
    """(the driver's window dict, the profiler) of one traced window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.annotate = True
    try:
        with profile(activities=acts) as prof:
            if device.type == "cuda":
                torch.cuda.synchronize()
            with spans.span("window"):
                window = driver.window(seconds)
                if device.type == "cuda":
                    torch.cuda.synchronize()
    finally:
        spans.annotate = False
    return window, prof


def _ns(e, what):
    """An event's start or duration in ns, whichever the version offers."""
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def kernel_kind(name):
    """"rollout" / "step" / "sim" of a port kernel's name, else None."""
    m = _KERNEL.search(name)
    return m.group(1) if m else None


class Info:
    """Device events, host annotations and host ops of the traced window:
    lists of (name, start ns, duration ns)."""

    def __init__(self, device_events, annotations, host_ops, t0, t1):
        self.t0, self.t1 = t0, t1
        self.device = [e for e in device_events
                       if e[1] >= t0 and e[1] + e[2] <= t1]
        self.annotations = annotations
        self.host_ops = host_ops
        self.window_s = (t1 - t0) / 1e9
        self.busy_s = self._union(self.device) / 1e9

    @staticmethod
    def _union(events):
        total, end = 0, None
        for _, s, d in sorted(events, key=lambda e: e[1]):
            a, b = s, s + d
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def device_s(self, pred=lambda name: True):
        """Seconds of device events whose name satisfies pred (summed, not
        merged: the port's kernels run one at a time on one stream)."""
        return sum(d for n, _, d in self.device if pred(n)) / 1e9

    def launches(self, pred):
        return sum(1 for n, _, _ in self.device if pred(n))

    def gaps(self):
        """(start ns, length ns) of each idle interval inside the window."""
        out, cur = [], self.t0
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if s > cur:
                out.append((cur, s - cur))
            cur = max(cur, s + d)
        if self.t1 > cur:
            out.append((cur, self.t1 - cur))
        return out

    def _host_at(self, t):
        """The innermost harness span and host op open at time t."""
        def inner(events):
            best = None
            for n, s, d in events:
                if s <= t <= s + d and (best is None or d < best[1]):
                    best = (n, d)
            return best[0] if best else None
        span = inner([e for e in self.annotations if e[0] != "window"])
        op = inner(self.host_ops)
        return " / ".join(x for x in (span or "between spans", op) if x)

    def breakdown(self):
        """The device operations that took most time (summed by name) and
        the longest idle gaps, each named by what the host was doing, 10
        of each, in seconds."""
        by_name = {}
        for n, _, d in self.device:
            key = n if len(n) <= 96 else n[:93] + "..."
            by_name[key] = by_name.get(key, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        longest = sorted(self.gaps(), key=lambda g: -g[1])[:10]
        gaps = [(self._host_at(s + d // 2), d) for s, d in longest]
        return {"device_ops": [[n, d / 1e9] for n, d in ops],
                "idle_gaps": [[n, d / 1e9] for n, d in gaps]}


def read(prof, span_names) -> Info:
    """Info of a traced window; span_names are the harness's annotations."""
    from torch.autograd import DeviceType
    names = set(span_names) | {"window"}
    dev, notes, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), _ns(e, "start"), _ns(e, "duration"))
        if item[0] in names:            # a span, also on the GPU timeline
            if e.device_type() != DeviceType.CUDA:
                notes.append(item)
        elif e.device_type() == DeviceType.CUDA:
            dev.append(item)
        else:
            ops.append(item)
    win = [n for n in notes if n[0] == "window"]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    _, t0, d = win[-1]
    return Info(dev, notes, ops, t0, t0 + d)

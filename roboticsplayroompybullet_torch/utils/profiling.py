"""Timing and tracing (port of roboticsplayroompybullet_tpu/utils/profiling.py).

`timeit` is the wall-clock microbench: best of N, each call waited for
(the card synchronised when the call returns CUDA tensors, in place of
JAX's block_until_ready); `trace` wraps torch.profiler for a Chrome
trace of the host and the card, in place of jax.profiler.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch


def _tensors(x):
    """The tensors in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _wait(out):
    """Wait for the device work behind `out`: synchronise each card that
    holds one of its tensors (CPU tensors are ready on return)."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def timeit(fn: Callable, *args, warmup: int = 1, reps: int = 3,
           **kw) -> float:
    """Best-of-`reps` seconds for fn(*args, **kw), each call waited for,
    after `warmup` calls (the first builds the kernels)."""
    for _ in range(warmup):
        _wait(fn(*args, **kw))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _wait(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, host and (when there is a card) CUDA activity:
    `with trace('build/trace'): run()`, then open logdir/trace.json in
    chrome://tracing or Perfetto. Yields the profiler (key_averages() for
    the sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

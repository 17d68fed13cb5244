"""Minimal gym-compatible space types (Box / Dict) — the port's own copy of
roboticsplayroompybullet_tpu/utils/spaces.py (numpy only).

The reference exposes `gym.spaces` objects (environments.py:117-166); these
are API-compatible lightweight equivalents, so the port has no gym
dependency while code using `.low/.high/.shape/.sample()` and dict-space
`.spaces` keeps working.
"""
from __future__ import annotations

import numpy as np


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        low = np.asarray(low, dtype=dtype)
        high = np.asarray(high, dtype=dtype)
        if shape is not None:
            low = np.broadcast_to(low, shape).astype(dtype)
            high = np.broadcast_to(high, shape).astype(dtype)
        self.low, self.high, self.dtype = low, high, dtype
        self.shape = self.low.shape

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and np.all(x >= self.low - 1e-6) \
            and np.all(x <= self.high + 1e-6)

    def __repr__(self):
        return f"Box{self.shape}"


class Dict:
    def __init__(self, spaces=None, **kw):
        self.spaces = dict(spaces or {}, **kw)

    def __getitem__(self, k):
        return self.spaces[k]

    def sample(self, rng=None):
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def __repr__(self):
        return f"Dict({list(self.spaces)})"

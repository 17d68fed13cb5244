"""Structured per-step metrics + host-side JSONL sink (port of
roboticsplayroompybullet_tpu/utils/metrics.py).

The reference exposes only `info={'is_success', 'target_poses'}`
(environments.py:214). Here each element of the play success test gets its
own bit (mirroring playRewardFunc.py:66-77), computed on the tensors'
device, and a sink drains scalars and tensors to JSONL on the host.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..envs.config import EnvConfig
from ..ops import spatial as sp


def play_element_bits(cfg: EnvConfig, ag: torch.Tensor,
                      g: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-element success bits of the play layout, (...,) bool each
    (thresholds from playRewardFunc.py:16-55)."""
    out = {}
    idx = 0
    for o in range(cfg.num_objects):
        dxyz = torch.abs(g[..., idx:idx + 3] - ag[..., idx:idx + 3])
        out[f"block{o}_pos_ok"] = (dxyz <= 0.05).all(-1)
        g_rpy = sp.quat_to_euler(sp.quat_normalize(g[..., idx + 3:idx + 7]))
        a_rpy = sp.quat_to_euler(sp.quat_normalize(ag[..., idx + 3:idx + 7]))
        out[f"block{o}_rot_ok"] = (torch.abs(g_rpy - a_rpy)
                                   <= math.pi / 4).all(-1)
        idx += 7
    names = ["drawer_ok", "door_ok", "button_ok", "dial_ok"]
    thr = [0.025, 0.04, 0.01, 0.3]
    for j, (nm, t) in enumerate(zip(names, thr)):
        out[nm] = torch.abs(g[..., idx + j] - ag[..., idx + j]) <= t
    return out


class JsonlSink:
    """Append-only JSONL metrics writer. `log(step, **scalars)` converts
    each value (a tensor on any device, a numpy array or a number) to
    Python numbers, one host copy a tensor: call at episode boundaries,
    not inside hot loops."""

    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, metrics: Optional[Dict] = None, **kw):
        rec = {"step": int(step), "ts": time.time()}
        for k, v in {**(metrics or {}), **kw}.items():
            a = v.detach() if isinstance(v, torch.Tensor) else np.asarray(v)
            rec[k] = a.item() if a.ndim == 0 else a.tolist()
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""EnvState ↔ numpy, by field name.

A JAX EnvState dumped as numpy arrays (one per field, batch leading) becomes
the port's EnvState and back, so states made by the JAX package (its reset,
the committed fixtures) drive the port, and the port's results can be held
to the JAX ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .envs.state import EnvState

FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


def _to_torch(name: str, a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if name == "rng":
        return torch.as_tensor(a.astype(np.int64), device=device)
    if name == "has_prev":
        return torch.as_tensor(a.astype(bool), device=device)
    if name == "t":
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def state_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> EnvState:
    """Mapping of field name → numpy array (batch leading) → EnvState."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    return EnvState(**{f: _to_torch(f, arrays[f], device) for f in FIELDS})


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """EnvState → field name → numpy array, in the JAX package's dtypes."""
    out = {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}
    out["rng"] = out["rng"].astype(np.uint32)
    return out

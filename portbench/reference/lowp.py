"""The plain twin one precision below its own: the benchmark's control.

Inside `lower_precision()` every floating result of a torch call is rounded
to the precision below its dtype: float32 to bfloat16, float64 to float32.
That is the arithmetic of the same code stored and computed in the lower
type (each bfloat16 operation computes in float32 and rounds its result),
without editing the twin. `lower_precision("float64")` rounds the float64
results alone: the control (action decode and IK) in float32, the substeps
as they are. The twin's cache of constants is swapped for one of each mode
while the mode is on, so that no rounded constant reaches the reference.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from . import twin

_LOWER = {torch.float32: torch.bfloat16, torch.float64: torch.float32}


def _round(x, lower):
    if isinstance(x, torch.Tensor):
        low = lower.get(x.dtype)
        return x if low is None else x.to(low).to(x.dtype)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_round(y, lower) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_round(y, lower) for y in x)
    return x


class _Lower(TorchFunctionMode):
    def __init__(self, lower):
        super().__init__()
        self.lower = lower

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _round(func(*args, **(kwargs or {})), self.lower)


_CACHES: dict = {}


@contextlib.contextmanager
def lower_precision(only=None):
    """Every floating result one precision below; with `only` ("float32"
    or "float64"), the results of that dtype alone."""
    lower = (_LOWER if only is None else
             {k: v for k, v in _LOWER.items() if str(k) == "torch." + only})
    saved = twin._CONST_CACHE
    twin._CONST_CACHE = _CACHES.setdefault(only, {})
    try:
        with _Lower(lower):
            yield
    finally:
        twin._CONST_CACHE = saved

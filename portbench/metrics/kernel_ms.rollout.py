"""Device ms per launch of the rollout kernel (`fs_rollout`), from the
profiler's kernel activities of the traced window. Moves rollouts_per_s."""
from portbench.trace import kernel_kind

UNIT = "ms"


def is_rollout(name):
    return kernel_kind(name) == "rollout"


def read(info, cell, window):
    if "calls" not in window:
        return None
    n = info.launches(is_rollout)
    return info.device_s(is_rollout) * 1e3 / n if n else None

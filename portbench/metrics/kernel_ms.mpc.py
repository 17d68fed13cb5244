"""Device ms per control step in the port's kernels: the planner's preview
launches of `fs_rollout` and the executed step's `fs_step`. Moves
mpc_step_ms_p95."""
from portbench.trace import kernel_kind

UNIT = "ms"


def read(info, cell, window):
    if not window.get("steps"):
        return None
    s = info.device_s(lambda n: kernel_kind(n) is not None)
    return s * 1e3 / window["steps"] if s else None

"""Device ms per rollout call outside the port's kernels: the entry's pack,
the rewards (`envs/rewards.py::compute_reward`) and the unpack, every
device operation that is not an `fs_*` kernel. Moves rollouts_per_s."""
from portbench.trace import kernel_kind

UNIT = "ms"


def read(info, cell, window):
    if not window.get("calls"):
        return None
    return (info.device_s(lambda n: kernel_kind(n) is None) * 1e3
            / window["calls"])

"""Device ms per control step outside the port's kernels: the MPC layer's
sampling, costs and MPPI update (`solver/mpc.py`, `solver/cost.py`), the
executed step's pack and unpack, the reward and the action's copy to the
host. Moves mpc_step_ms_p95."""
from portbench.trace import kernel_kind

UNIT = "ms"


def read(info, cell, window):
    if not window.get("steps"):
        return None
    return (info.device_s(lambda n: kernel_kind(n) is None) * 1e3
            / window["steps"])

"""Share of the traced window in which no device operation ran, in an MPC
cell. Moves mpc_step_ms_p95."""
UNIT = "%"


def read(info, cell, window):
    if not window.get("steps") or info.busy_s <= 0:
        return None
    return 100.0 * (1.0 - info.busy_s / info.window_s)

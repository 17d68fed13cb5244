"""Share of the traced window in which no device operation ran, in a
rollout cell. Moves rollouts_per_s."""
UNIT = "%"


def read(info, cell, window):
    if "calls" not in window or info.busy_s <= 0:
        return None
    return 100.0 * (1.0 - info.busy_s / info.window_s)

"""Host ms per control step from the step's start until the planner, the
executed step and its reward have been enqueued, before the action is read
back (the mean over the traced window's steps). Moves mpc_step_ms_p95."""
UNIT = "ms"


def read(info, cell, window):
    ms = window.get("enqueue_ms")
    return sum(ms) / len(ms) if ms else None

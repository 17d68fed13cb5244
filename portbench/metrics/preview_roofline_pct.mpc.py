"""One preview launch's share of its roofline: the least time an H100
could take for the work of a preview rollout (B = pop, H = horizon, the
preview's 8 IK / 8 solver iterations; portbench/roofline) over the mean
device time of the window's `fs_rollout` launches. Moves mpc_step_ms_p95."""
from portbench.reference import build_model
from portbench.roofline.work import bound_ms, rollout_work
from portbench.trace import kernel_kind

UNIT = "%"


def is_rollout(name):
    return kernel_kind(name) == "rollout"


def read(info, cell, window):
    if not window.get("steps"):
        return None
    n = info.launches(is_rollout)
    if not n:
        return None
    p = cell.params
    model = build_model(cell.config["env_id"])
    bound, _ = bound_ms(*rollout_work(
        *model, int(p["pop"]), int(p["horizon"]),
        ik_iters=int(p.get("preview_ik_iters", 8)),
        solve_iters=int(p.get("preview_solve_iters", 8))))
    return 100.0 * bound / (info.device_s(is_rollout) * 1e3 / n)

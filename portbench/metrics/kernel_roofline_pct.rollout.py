"""The rollout kernel's share of its roofline: the least time an H100 could
take for the work of one launch (portbench/roofline, frozen counts of the
model's static structure, at the cell's B and H) over the measured device
time per launch. Moves rollouts_per_s."""
from portbench.reference import build_model
from portbench.roofline.work import bound_ms, rollout_work
from portbench.trace import kernel_kind

UNIT = "%"


def is_rollout(name):
    return kernel_kind(name) == "rollout"


def read(info, cell, window):
    if "calls" not in window:
        return None
    n = info.launches(is_rollout)
    if not n:
        return None
    ms = info.device_s(is_rollout) * 1e3 / n
    model = build_model(cell.config["env_id"])
    bound, _ = bound_ms(*rollout_work(*model, int(cell.params["batch"]),
                                      int(cell.params["horizon"])))
    return 100.0 * bound / ms

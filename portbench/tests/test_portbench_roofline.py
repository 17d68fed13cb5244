"""The frozen work count reproduces the port's chip_smoke.py::work per env
and control step."""
import pytest

from portbench.reference import build_model
from portbench.roofline import work


@pytest.mark.parametrize("env_id, want", [
    ("UR5PlayAbsRPY1Obj-v0", (1899148, 64073, 432)),
    ("pandaPlay-v0", (2996944, 39499, 520)),
])
def test_work_per_env_step(env_id, want):
    assert work.rollout_work(*build_model(env_id), 1, 1) == want


def test_bounds_of_the_cells():
    ur5 = build_model("UR5PlayAbsRPY1Obj-v0")
    ms, by = work.bound_ms(*work.rollout_work(*ur5, 4096, 40))
    assert by == "operations" and abs(ms - 4.644125) < 1e-5
    ms, _ = work.bound_ms(*work.rollout_work(*ur5, 1024, 10, ik_iters=8))
    assert abs(ms - 0.290258) < 1e-5

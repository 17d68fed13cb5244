"""The control, the plain reference one precision below its own (float32
as bfloat16, float64 as float32) put in the program's place, comes out not
correct under each cell's limits; the program comes out correct. At a
small size on the CPU, where the program runs its plain twin; on the card
`portbench/control.py` reads both at the cells' own sizes."""
import pytest
import torch

from portbench import control, harness

SMALL = {
    "ur5play-rollout-b4096-h40": {"batch": 4, "horizon": 2,
                                  "input_sets": 1},
    "pandaplay-rollout-b4096-h40": {"batch": 4, "horizon": 2,
                                    "input_sets": 1},
    "ur5play-mpc-pop1024-h10": {"pop": 4, "horizon": 2, "iters": 1,
                                "episode_steps": 4, "episodes": 2,
                                "check_steps": 8},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_and_program_passes(workload):
    limits = harness.load_workload(workload)["limits"]
    got = {kind: nums for kind, nums, _, _ in control.readings(
        workload, 3000000023, 0, True, torch.device("cpu"), SMALL[workload])}
    program_ok, _ = harness.judge(got["program"], limits)
    control_ok, lines = harness.judge(got["control"], limits)
    assert program_ok, got["program"]
    assert not control_ok, lines

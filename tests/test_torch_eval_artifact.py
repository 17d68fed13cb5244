"""Pin floors under the PyTorch port's MPC task-competence artifact
(EVAL_TORCH.json).

EVAL_TORCH.json is written by `python tools/eval_mpc_torch.py` on an NVIDIA
H100: the port's fused receding-horizon MPPI planner
(roboticsplayroompybullet_torch/solver/eval.py) through its CUDA kernels,
12 families x 16 episodes, seed 0, success per the reference's
all-or-nothing play criterion (playRewardFunc.py:16-77). The floors are
the JAX package's (tests/test_eval_artifact.py), copied: the port is held
to the same bar per family, and pooled over the 12 families to JAX's
EVAL.json less three standard errors of the difference of two rates.
"""
import json
import math
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PATH = os.path.join(ROOT, "EVAL_TORCH.json")

# family -> minimum success rate (tests/test_eval_artifact.py's FLOORS)
FLOORS = {
    "reach": 0.60,
    "block": 0.375,
    "drawer": 0.60,
    "door": 0.60,
    "button": 0.60,
    "dial": 0.60,
    "panda_block": 0.375,
    "panda_drawer": 0.60,
    "panda_door": 0.60,
    "panda_button": 0.60,
    "panda_dial": 0.375,
    "pick": 0.25,
}
EPISODES = 16


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def artifact():
    return _load(PATH)


def test_eval_torch_artifact_provenance(artifact):
    """The committed artifact is the port's sweep on an H100 through the
    CUDA kernels: both arms and pick, 1024 candidates, H=10, seed 0, 16
    episodes a family."""
    meta = artifact["meta"]
    assert meta["backend"] == "cuda" and meta["platform"] == "cuda", meta
    assert "H100" in meta["device"] and "H100" in meta["nvidia_smi"], meta
    assert meta["env"] == "UR5PlayAbsRPY1Obj-v0", meta
    assert meta.get("panda_env") == "pandaPlayAbsRPY1Obj-v0", meta
    assert meta.get("pick_env") == "pandaPick-v0", meta
    assert meta["mpc"]["pop"] >= 1024 and meta["mpc"]["horizon"] == 10, meta
    assert meta["seed"] == 0 and meta["n_substeps"] is None, meta
    assert sorted(artifact["families"]) == sorted(FLOORS)
    for fam, rec in artifact["families"].items():
        assert rec["n_episodes"] == EPISODES, (fam, rec)


@pytest.mark.parametrize("family", sorted(FLOORS))
def test_eval_torch_success_floor(artifact, family):
    rec = artifact["families"][family]
    assert rec["success_rate"] >= FLOORS[family], (
        f"{family}: {rec['success_rate']:.3f} < floor {FLOORS[family]}")


def test_eval_torch_pooled_against_jax(artifact):
    """The port's successes over the 12 families are at least the JAX
    package's (EVAL.json, 171/192 on a TPU) less three standard errors of
    the difference of two independent rates at that level: 153/192."""
    jax_fams = _load(os.path.join(ROOT, "EVAL.json"))["families"]
    n = sum(r["n_episodes"] for r in jax_fams.values())
    p = sum(r["n_success"] for r in jax_fams.values()) / n
    floor = math.ceil(n * (p - 3 * math.sqrt(2 * p * (1 - p) / n)))
    assert (n, floor) == (192, 153)
    fams = artifact["families"]
    got = sum(fams[f]["n_success"] for f in FLOORS)
    assert sum(fams[f]["n_episodes"] for f in FLOORS) == n
    assert got >= floor, f"{got}/{n} < {floor}/{n}"

"""Pin floors under the PyTorch port's LfP artifact (LFP_EVAL_TORCH.json).

Written on an NVIDIA H100 by the port's chain at the JAX package's recipe
(LFP_EVAL.json): tools/collect_play_torch.py (2048 play episodes x 200
steps through the step kernel), tools/train_lfp_torch.py (15k Adam steps,
512x512, batches of 256 windows x 16), tools/eval_lfp_torch.py (256
episodes, window 16, seed 0). The floors are tests/test_lfp_artifact.py's,
copied: window-goal success >= 0.15 and >= 3x the play-process baseline,
the final-goal distance ratio <= 0.85 and the EE-distance ratio <= 0.95.
"""
import json
import os

import pytest

PATH = os.path.join(os.path.dirname(__file__), "..", "LFP_EVAL_TORCH.json")


@pytest.fixture(scope="module")
def artifact():
    with open(PATH) as f:
        return json.load(f)


def test_lfp_torch_artifact_provenance(artifact):
    """tests/test_lfp_artifact.py's provenance, on the card, at the full
    recipe."""
    meta = artifact["meta"]
    assert meta["episodes"] >= 64, meta
    assert meta["window"] >= 8, meta
    assert meta.get("actor") == "play_policy.make_play_actor", meta
    assert meta["platform"] == "gpu", meta
    assert "H100" in meta["device"] and "H100" in meta["nvidia_smi"], meta
    assert (meta["env"], meta["episodes"], meta["window"], meta["hidden"],
            meta["seed"]) == ("UR5PlayAbsRPY1Obj-v0", 256, 16, [512, 512],
                              0), meta
    collect, train = artifact["stages"]["collect"], \
        artifact["stages"]["train"]
    assert (collect["policy"], collect["batch"], collect["steps"],
            collect["device"]) == ("play", 2048, 200, "cuda"), collect
    assert (train["steps"], train["batch"], train["window"], train["hidden"],
            train["device"]) == (15000, 256, 16, [512, 512], "cuda"), train


def test_lfp_torch_window_goal_success(artifact):
    pol = artifact["policy"]["success_rate_any"]
    rnd = artifact["random"]["success_rate_any"]
    assert pol >= 0.15, (
        f"policy window-goal success {pol:.3f} < 0.15 absolute floor")
    assert pol >= 3.0 * rnd, (
        f"policy success {pol:.3f} < 3x baseline {rnd:.3f}")


def test_lfp_torch_policy_beats_random(artifact):
    ratio = artifact["final_dist_ratio_policy_over_random"]
    assert ratio <= 0.85, (
        f"trained policy final-goal distance is {ratio:.3f}x random")
    ee_ratio = (artifact["policy"]["final_ee_dist_mean_m"]
                / max(artifact["random"]["final_ee_dist_mean_m"], 1e-9))
    assert ee_ratio <= 0.95, artifact

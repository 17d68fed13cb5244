"""Without a card, or without the program beside it, a run exits non-zero
and prints no result."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = harness.ROOT


def run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ur5play-rollout-b4096-h40", "--seed", "3000000019", "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks a machine without one")
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""

"""Every configuration, workload and metric of the benchmark is a file found
by its name, and a file added in a copy is found with no other edit."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_data_file_parses(kind):
    names = harness.available(kind)
    assert names
    for name in names:
        d = harness._json(kind, name)
        assert d["name"] == name


def test_each_workload_names_files_that_exist():
    for name in harness.available("workloads"):
        w = harness.load_workload(name)
        assert w["config"] in harness.available("configs")
        assert w["driver"] in harness.available("traffic")
        harness.load_module("traffic", w["driver"]).Driver


def test_benchmark_entries_are_files():
    b = bench()
    assert {c["name"] for c in b["configs"]} <= set(
        harness.available("configs"))
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.load_config(c["name"])["source"] == c["source"]
    for w in b["workloads"]:
        d = harness.load_workload(w["name"])
        assert (d["config"], d["traffic"], d["chips"], d["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    readers = set(harness.available("metrics"))
    for m in b["per_layer"]:
        assert m["name"] in readers
        mod = harness.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)


def test_a_workload_added_in_a_copy_is_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    src = tmp_path / "portbench" / "workloads"
    w = json.loads((src / "ur5play-rollout-b4096-h40.json").read_text())
    w.update(name="ur5play-rollout-b1024-h40", params=dict(w["params"],
                                                           batch=1024))
    (src / "ur5play-rollout-b1024-h40.json").write_text(json.dumps(w))
    out = subprocess.run(
        [sys.executable, "-c",
         "from portbench import harness as h; "
         "print(h.available('workloads')); "
         "print(h.load_workload('ur5play-rollout-b1024-h40')['params']"
         "['batch'])"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ur5play-rollout-b1024-h40" in out.stdout
    assert out.stdout.strip().endswith("1024")


def test_a_name_outside_the_rules_is_refused():
    with pytest.raises(harness.Refused):
        harness.load_workload("../BENCHMARK")
    with pytest.raises(harness.Refused):
        harness.load_workload("no-such-cell")

"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

The JAX outputs the port is held to come from committed fixtures
(tests/torch_fixtures/*.npz, written by tools/gen_port_fixtures.py), so no
port test compiles the JAX lane twin. Each fixture records the sha256 of
the JAX sources it depends on; `load` refuses a stale one.
"""
import hashlib
import json
import os

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")


def load(name: str) -> dict:
    """Fixture `name` as a dict of numpy arrays, after checking that the
    JAX sources it was made from are unchanged."""
    with np.load(os.path.join(FIXTURES, name + ".npz")) as z:
        d = {k: z[k] for k in z.files}
    for rel, digest in json.loads(str(d.pop("sources_json"))).items():
        with open(os.path.join(ROOT, rel), "rb") as f:
            now = hashlib.sha256(f.read()).hexdigest()
        assert now == digest, (
            f"{rel} changed since tests/torch_fixtures/{name}.npz was written:"
            " regenerate with tools/gen_port_fixtures.py")
    return d


def key(env_id: str) -> str:
    return env_id.replace("-v0", "")


def field_slices(cfg, tree):
    """(name, slice) of each non-empty field of the packed (NF, B) rows."""
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    rows, _ = fs._field_rows(cfg, tree)
    out, i = [], 0
    for name, r in rows:
        if r:
            out.append((name, slice(i, i + r)))
        i += r
    return out

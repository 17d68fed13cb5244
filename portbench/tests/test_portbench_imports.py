"""Nothing under portbench/ imports JAX or the JAX package; the reference
and the roofline import nothing of the program. Module names are compared
by their top-level name, whole."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "roboticsplayroompybullet_tpu"}
PROGRAM = "roboticsplayroompybullet_torch"


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_imports(path):
    tops = set(top_levels(path))
    assert not tops & FORBIDDEN
    rel = os.path.relpath(path, HERE).split(os.sep)[0]
    if rel in ("reference", "roofline"):
        assert PROGRAM not in tops


def test_the_names_are_whole():
    assert "roboticsplayroompybullet_torch".split(".")[0] not in FORBIDDEN

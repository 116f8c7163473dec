"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``cppf_tpu_torch`` is not ``cppf_tpu``."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cppf_tpu"}
PROGRAM = "cppf_tpu_torch"


def modules():
    for d, _, files in os.walk(ROOT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_there_are_modules():
    assert len(list(modules())) > 10


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(p for p in modules()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_is_independent(path):
    assert PROGRAM not in set(top_level_imports(path)), f"{path} imports the program"


def test_the_guard_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import cppf_tpu_torch.ops\nfrom jax import numpy\nimport cppf_tpu.ops\n")
    assert set(top_level_imports(str(probe))) == {"cppf_tpu_torch", "jax", "cppf_tpu"}
    assert set(top_level_imports(str(probe))) & FORBIDDEN == {"jax", "cppf_tpu"}

"""What the benchmark may import: no module under ``benchmark/`` imports
``jax``, ``jaxlib``, ``flax`` or the JAX package (top-level names compared
whole: the program's own name begins with the JAX package's); nothing under
``benchmark/reference/`` imports the program; the HTTP client imports the
standard library alone."""
import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "aa_clip_iqm_tpu"}
PROGRAM = "aa_clip_iqm_tpu_torch"


def modules():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    """Top-level names of every import in the file, wherever it stands."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def rel(path):
    return os.path.relpath(path, HERE)


@pytest.mark.parametrize("path", sorted(modules()), ids=rel)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in modules()
                                        if rel(p).startswith("reference" + os.sep)), ids=rel)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and "benchmark" not in names


def test_the_check_compares_whole_names():
    assert "aa_clip_iqm_tpu" != PROGRAM.split(".")[0]
    assert top_level_imports(os.path.join(HERE, "drivers", "offline.py")) & FORBIDDEN == set()


def test_client_uses_the_standard_library_alone():
    names = top_level_imports(os.path.join(HERE, "http_client.py"))
    assert names <= set(sys.stdlib_module_names)

"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program: the AST of every module under
``benchmark/`` (its tests aside), compared by whole top-level names."""

import ast
import os

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "ganecdotes_tpu"}
PROGRAM = {"ganecdotes_torch"}


def modules():
    for dirpath, dirnames, files in os.walk(BENCH_DIR):
        dirnames[:] = [d for d in dirnames if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of every import in the file, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_the_walk_finds_the_harness_and_the_reference():
    rel = {os.path.relpath(p, BENCH_DIR) for p in modules()}
    assert {"run.py", "harness/main.py",
            "reference/stylegan2_swav.py"} <= rel


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_and_a_reference_free_of_the_program(path):
    names = imported(path)
    assert not names & JAX, f"{path} imports {names & JAX}"
    if os.path.relpath(path, BENCH_DIR).startswith("reference" + os.sep):
        assert not names & PROGRAM, f"{path} imports {names & PROGRAM}"


def test_names_are_compared_whole():
    from harness.main import forbidden_modules

    assert forbidden_modules(["ganecdotes_torch", "ganecdotes_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "ganecdotes_tpu.ops"]) == [
        "ganecdotes_tpu", "jax"]

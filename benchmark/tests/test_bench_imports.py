"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the port: each imported module's top-level
name is compared whole (``rslmtoasa_tpu_torch`` is not ``rslmtoasa_tpu``)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "rslmtoasa_tpu"}


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """(top-level names of absolute imports, relative imports' levels and
    modules) of one file."""
    tree = ast.parse(open(path).read(), path)
    names, rel = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel.append((node.level, node.module))
            else:
                names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names, rel


@pytest.mark.parametrize("path", sorted(sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    names, _ = imported(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


@pytest.mark.parametrize(
    "path", sorted(sources(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_stands_alone(path):
    names, rel = imported(path)
    assert "rslmtoasa_tpu_torch" not in names and "benchmark" not in names
    # relative imports stay inside benchmark/reference
    depth = os.path.relpath(os.path.dirname(path),
                            os.path.join(BENCH, "reference")).count(os.sep)
    depth += 0 if os.path.dirname(path).endswith("reference") else 1
    for level, _ in rel:
        assert level <= depth + 1, f"{path} imports from outside reference"


def test_names_are_whole_words():
    assert "rslmtoasa_tpu_torch".split(".")[0] not in FORBIDDEN

"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``; the repository's ``pytest tests/`` does not collect
them).  Tests marked ``gpu`` need a card and skip here, decided in a
fixture; the rest run the harness on the CPU at small boxes."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_root(where, n: int = 6) -> str:
    """A copy of the benchmark whose configurations are cut to an n^3 box,
    under ``where``; returns its root."""
    root = os.path.join(str(where), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    cdir = os.path.join(root, "benchmark", "configs")
    for f in os.listdir(cdir):
        path = os.path.join(cdir, f)
        with open(path) as fh:
            cfg = json.load(fh)
        cfg["n1"] = cfg["n2"] = cfg["n3"] = n
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    return root


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """The benchmark at box 6."""
    return small_root(tmp_path_factory.mktemp("bench"))

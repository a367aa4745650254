"""Fixtures of the benchmark's CPU tests: a copy of the harness whose
cells are cut to a size the CPU renders in a second (``tiny``), and the
manifest. Tests that need the card are marked ``gpu`` and skip inside a
fixture without one."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CELLBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(CELLBENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(2)


def _edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny(tmp_path):
    """A copy of ``cellbench/`` with every cell cut to 3,000 points, 2 views
    of 32 px and (learned) a U-Net of width 8."""
    root = str(tmp_path / "cellbench")
    shutil.copytree(CELLBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))

    def cfg(d):
        d["cloud"]["points"] = 3000
        if "pcml_info" in d:
            d["pcml_info"]["clr_encoder_channels"] = "9 8 8 8 8 8"
        if d["raster"].get("k_budget"):
            d["raster"]["k_budget"] = 20000
        if d["raster"].get("max_active"):
            d["raster"]["max_active"] = 3

    def traffic(d):
        d["views"], d["width"], d["height"] = 2, 32, 32

    for name in os.listdir(os.path.join(root, "configs")):
        _edit(os.path.join(root, "configs", name), cfg)
    for name in os.listdir(os.path.join(root, "traffic")):
        _edit(os.path.join(root, "traffic", name), traffic)
    return root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

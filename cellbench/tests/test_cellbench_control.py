"""The control on the card: the reference computed with TF32 matmuls in
the program's place fails the cell's check, while the program passes it,
at a size a test run holds (the cell's cloud and widths, 2 views of one
request)."""

import json
import os
import shutil

import pytest

from cellbench import control, harness

CELLS = ("pcml800k.circle12", "splat800k.orbit16")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(card, tmp_path, manifest,
                                                  cell):
    root = str(tmp_path / "cellbench")
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    work = harness.load_json(os.path.join(root, "workloads", cell + ".json"))
    work["sample_requests"] = 1
    with open(os.path.join(root, "workloads", cell + ".json"), "w") as f:
        json.dump(work, f)
    path = os.path.join(root, "traffic", work["traffic"] + ".json")
    traffic = harness.load_json(path)
    traffic["views"] = 2
    with open(path, "w") as f:
        json.dump(traffic, f)
    for seed in (101, 102, 103):
        lines = control.readings(cell, seed, ("program", "control"),
                                 device="cuda", root=root, manifest=manifest)
        by = {line["side"]: line for line in lines}
        for key, lim in work["limits"].items():
            assert by["program"][key] <= lim, (seed, key, by)
        assert any(by["control"][key] > lim
                   for key, lim in work["limits"].items()), (seed, by)

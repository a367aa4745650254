"""Cells, configurations, traffic mixes and metrics are found by name, and
a cell added as files runs without an edit to the harness."""

import json
import os
import re

from cellbench import harness, systems

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_files_that_exist(manifest):
    assert manifest["command"] == ["python3", "cellbench/run.py"]
    assert manifest["paths"] == ["cellbench"]
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        with open(os.path.join(harness.REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"], manifest=manifest)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert w["chips"] == 1
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(harness.load_reader(m["name"]))
    assert {m["name"] for m in manifest["end_to_end"]} >= {"setup_s"}
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_e2e_and_a_per_layer(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest=manifest)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_systems_load_by_renderer_kind(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest=manifest)
        mod = systems.load(cell["config"]["renderer"])
        assert hasattr(mod, "Program") and hasattr(mod, "reference_splats")


def test_a_cell_added_from_files_runs(tiny, manifest):
    """A new traffic mix, cell and metric, written as files beside the
    others, run through the unchanged harness."""
    with open(os.path.join(tiny, "traffic", "orbit3.json"), "w") as f:
        json.dump({"name": "orbit3", "views": 3, "width": 16, "height": 16,
                   "supersample": 2, "fov_deg": 60.0, "ring_radius": 2.5,
                   "arrival": "closed_loop", "clients": 1}, f)
    with open(os.path.join(tiny, "workloads", "splat800k.orbit3.json"),
              "w") as f:
        json.dump({"name": "splat800k.orbit3", "config": "splat_thuman800k",
                   "traffic": "orbit3", "warm_requests": 1,
                   "sample_requests": 1, "sync_requests": 1,
                   "trace_requests": 1,
                   "limits": {"image_mae": 1e-4}}, f)
    with open(os.path.join(tiny, "metrics", "views_per_s.py"), "w") as f:
        f.write("def read(ctx):\n    return 3e3 / ctx.request_ms\n")
    man = dict(manifest)
    man["workloads"] = manifest["workloads"] + [
        {"name": "splat800k.orbit3", "config": "splat_thuman800k",
         "traffic": "orbit3", "chips": 1, "why": "test"}]
    man["end_to_end"] = manifest["end_to_end"] + [
        {"name": "views_per_s", "unit": "views/s", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["splat800k.orbit3"]}]
    r = harness.run("splat800k.orbit3", 7, 0.3, False, device="cpu",
                    root=tiny, manifest=man)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "views_per_s"}
    assert list(r)[-1] == "checks"


def test_a_trace_without_device_activity_leaves_its_metrics_out(tiny,
                                                                 manifest):
    """On the CPU the profiler records no device activity: the traced run
    leaves out every metric read from the trace, and ``busy_s``,
    ``window_s`` and ``breakdown``, instead of measuring another way."""
    r = harness.run("splat800k.orbit16", 11, 0.3, True, device="cpu",
                    root=tiny, manifest=manifest)
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"rgb_ms.splat"}
    assert "busy_s" not in r["device"] and "breakdown" not in r

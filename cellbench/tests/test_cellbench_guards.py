"""The run refuses JAX and the JAX package by whole top-level name, and a
measurement run without a card fails instead of running on the CPU."""

import io
import json
import os
import subprocess
import sys
import types

from cellbench import harness

REPO = harness.REPO


def test_top_level_names_are_compared_whole(monkeypatch):
    import gpcr_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpcr_tpu_torchx", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpcr_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["gpcr_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["gpcr_tpu", "jax"]


def test_a_result_with_jax_loaded_is_not_printed(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.print_result({"checks": {}}, out, err)
    assert rc == 3 and out.getvalue() == "" and "flax" in err.getvalue()


def test_the_result_line_ends_with_the_checks():
    out, err = io.StringIO(), io.StringIO()
    res = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
           "device": {}, "checks": {"image_mae": {"value": 1e-7,
                                                  "limit": 1e-5}}}
    assert harness.print_result(res, out, err) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.getvalue().splitlines()[-1] == "check image_mae 1e-07 limit 1e-05"


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "splat800k.orbit16", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_the_run_fails_and_prints_no_result():
    r = _run_py(REPO)
    assert r.returncode == 2, r.stderr
    assert r.stdout == "" and "no CUDA device" in r.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and cellbench/: no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "cellbench"), tmp_path / "cellbench")
    r = _run_py(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""

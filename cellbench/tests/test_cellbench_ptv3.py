"""The PTv3 cell: ``attn_roofline``'s arithmetic on a hand-counted case, the
system module running the cell through the unchanged harness on the CPU at
a tiny size, and a fault planted in the program's attention (one head's
scale off) coming out not correct."""

import json
import os

import pytest

from cellbench import harness, systems
from cellbench.measure import PEAKS

CELL = "ptv3_800k.circle12"
KERNEL = "void (anonymous namespace)::patch_attn_kernel<16>(Args)"


def _reader():
    return harness.load_reader("attn_roofline")


def test_attn_roofline_arithmetic():
    # one request: a launch bound by operations (67 GFLOP: 1 ms at 67
    # TFLOP/s) and one by bytes (3.35 GB: 1 ms at 3.35 TB/s); two profiled
    # requests take 8 ms of the kernel: 4 ms of bound, 50%
    work = [[67e9, 1e6], [1e3, 3.35e9]]
    ctx = harness.Ctx(completed=3, window_s=1.0, peaks=PEAKS["H100"],
                      timings=[{"model_time": 0.1, "attn_work": work}] * 3,
                      trace={"requests": 2, "busy_s": 0.02, "window_s": 0.03,
                             "by_name": {KERNEL: 0.008, "other": 1.0}})
    assert _reader()(ctx) == pytest.approx(50.0)


def test_attn_roofline_reads_nothing_where_nothing_is_there():
    read = _reader()
    base = dict(completed=1, window_s=1.0, peaks=PEAKS["H100"])
    trace = {"requests": 2, "busy_s": 0.02, "window_s": 0.03,
             "by_name": {KERNEL: 0.008}}
    work = [{"attn_work": [[1e9, 1e6]]}]
    # no trace (an untraced run), no peaks (another card), no work counted
    # (another system), no such kernel (a program without it)
    assert read(harness.Ctx(**base, timings=work)) is None
    assert read(harness.Ctx(completed=1, window_s=1.0, timings=work,
                            trace=trace)) is None
    assert read(harness.Ctx(**base, timings=[{}], trace=trace)) is None
    assert read(harness.Ctx(**base, timings=work, trace=dict(
        trace, by_name={"stream_blend_kernel": 1.0}))) is None


def _small(tiny):
    """Cut the tiny copy's PTv3 configuration to a backbone the CPU runs
    in a second: head dim 8, patches of 64; and scale factor 32, so that a
    voxel is about a pixel wide in the tiny views, as it is in the cell's
    1024^2 views at 448 (at 448 the offsets the network predicts move a
    splat by ~0.03 px of a 32 px view, and the images barely show it)."""
    path = os.path.join(tiny, "configs", "ptv3_thuman800k.json")
    with open(path) as f:
        d = json.load(f)
    d["cloud"]["scale_factor"] = d["pcml_info"]["scale_factor"] = 32
    d["pcml_info"].update({
        "patch_size": 64, "enc_channels": [8, 16, 16, 16, 16],
        "enc_heads": [1, 2, 2, 2, 2], "enc_depths": [1, 1, 1, 2, 1],
        "dec_channels": [16, 16, 16, 16], "dec_heads": [2, 2, 2, 2],
        "dec_depths": [1, 1, 1, 1]})
    with open(path, "w") as f:
        json.dump(d, f)
    return tiny


def _run(root, manifest, wrap=None):
    return harness.run(CELL, 2**31 + 19, 0.3, False, device="cpu",
                       root=root, manifest=manifest, wrap=wrap)


def test_the_cell_loads_and_the_sound_program_is_correct(tiny, manifest):
    cell = harness.load_cell(CELL, manifest=manifest)
    assert cell["config"]["renderer"] == "ptv3"
    assert cell["config"]["pcml_info"]["model_type"] == "ptv3"
    assert {m["name"] for m in cell["end_to_end"]} == {"request_ms",
                                                       "setup_s"}
    assert "attn_roofline" in {m["name"] for m in cell["per_layer"]}
    mod = systems.load("ptv3")
    assert hasattr(mod, "Program") and hasattr(mod, "reference_splats")
    r = _run(_small(tiny), manifest)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["views_missing"]["value"] == 0


def test_a_fault_in_the_attention_is_not_correct(tiny, manifest,
                                                 monkeypatch):
    """Head 0's queries scaled by 2 in the program's attention (the plain
    path the CPU takes): its softmax is sharper than the reference's."""
    from gpcr_tpu_torch.ops import patch_attn

    real = patch_attn.patch_attention_plain

    def faulty(qkv, pt, heads):
        d = qkv.shape[1] // (3 * heads)
        qkv = qkv.clone()
        qkv[:, :d] *= 2.0
        return real(qkv, pt, heads)

    monkeypatch.setattr(patch_attn, "patch_attention_plain", faulty)
    r = _run(_small(tiny), manifest)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())

"""The Swin3D cell: ``swin_attn_roofline``'s arithmetic on a hand-counted
case and on the least count (a kernel doing at least the least work at
the card's peak reads at most 100%), the reference's own checks (its
cross-set brute-force kNN against an exhaustive order, its pair-form
window attention against a per-query loop), the system module running the
cell through the unchanged harness on the CPU at a tiny size, and faults
planted in the program coming out not correct: the colour terms of cRSE
dropped, the value table dropped, the shift never applied (on the CPU at a
tiny size) and, on the card at the cell's widths, those three and TF32 on."""

import json
import os
import shutil

import pytest
import torch

from cellbench import harness, systems
from cellbench.measure import PEAKS
from cellbench.reference import swin3d as REF

CELL = "swin3d_800k.circle12"
KERNEL = "void (anonymous namespace)::swin_attn_kernel<16>(Args)"


def _reader():
    return harness.load_reader("swin_attn_roofline")


def test_swin_attn_roofline_arithmetic():
    # one request: a launch bound by operations (67 GFLOP: 1 ms at 67
    # TFLOP/s) and one by bytes (3.35 GB: 1 ms at 3.35 TB/s); two profiled
    # requests take 8 ms of the kernel: 4 ms of bound, 50%
    work = [[67e9, 1e6], [1e3, 3.35e9]]
    ctx = harness.Ctx(completed=3, window_s=1.0, peaks=PEAKS["H100"],
                      timings=[{"model_time": 0.1, "swin_attn_work": work}] * 3,
                      trace={"requests": 2, "busy_s": 0.02, "window_s": 0.03,
                             "by_name": {KERNEL: 0.008, "other": 1.0}})
    assert _reader()(ctx) == pytest.approx(50.0)


def test_swin_attn_roofline_reads_nothing_where_nothing_is_there():
    read = _reader()
    base = dict(completed=1, window_s=1.0, peaks=PEAKS["H100"])
    trace = {"requests": 2, "busy_s": 0.02, "window_s": 0.03,
             "by_name": {KERNEL: 0.008}}
    work = [{"swin_attn_work": [[1e9, 1e6]]}]
    assert read(harness.Ctx(**base, timings=work)) is None
    assert read(harness.Ctx(completed=1, window_s=1.0, timings=work,
                            trace=trace)) is None
    assert read(harness.Ctx(**base, timings=[{}], trace=trace)) is None
    assert read(harness.Ctx(**base, timings=work, trace=dict(
        trace, by_name={"gva_kernel": 1.0}))) is None


@pytest.mark.parametrize("m,heads,d", [(1, 6, 8), (125, 6, 8), (40, 24, 16),
                                       (343, 24, 16)])
def test_the_least_count_keeps_the_share_at_or_under_100(m, heads, d):
    """The least count is below the pair form's (every pair's 18 table
    rows: 18 d per pair and head beside the 4 d + 1 of the attention
    proper) at every width, so a kernel of either form that ran at the
    card's float32 peak on its own operations reads at most 100%; and a
    kernel that did exactly the least work at the peak reads 100%."""
    pairs = 50 * m * m
    ops = REF.attn_least_ops(pairs, heads, d)
    pair_form = pairs * heads * (4 * d + 1 + 18 * d)
    assert ops < pair_form
    peaks = PEAKS["H100"]
    work = [[ops, REF.attn_least_bytes(50 * m, 50, heads * d, 264)]]
    bound = max(ops / peaks["fp32_flops"],
                work[0][1] / peaks["hbm_bytes_per_s"])
    for kernel_s, want in ((bound, 100.0),
                           (pair_form / peaks["fp32_flops"], None)):
        ctx = harness.Ctx(completed=1, window_s=1.0, peaks=peaks,
                          timings=[{"swin_attn_work": work}],
                          trace={"requests": 1, "by_name": {
                              KERNEL: max(kernel_s, bound)}})
        share = _reader()(ctx)
        assert share <= 100.0 + 1e-9
        if want is not None:
            assert share == pytest.approx(want)


def test_the_reference_knn_is_the_exhaustive_order():
    """The screened cross-set brute force against ordering all n points of
    every query, on a lattice with many ties and on float means."""
    gen = torch.Generator().manual_seed(1)
    lattice = torch.stack(torch.meshgrid(*[torch.arange(8)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    for pts, qs in ((lattice.double(), lattice.double()[::7] + 0.5),
                    (torch.rand((700, 3), generator=gen, dtype=torch.float64),
                     torch.rand((90, 3), generator=gen, dtype=torch.float64)
                     * 1.2 - 0.1)):
        for k in (3, 16):
            got = REF.knn(pts, qs, k)
            d2 = ((qs[:, None] - pts[None]) ** 2).sum(-1)
            full = torch.arange(pts.shape[0])[None].expand(qs.shape[0], -1)
            assert torch.equal(got, REF._ordered(d2, full, k))
    with pytest.raises(ValueError, match="fewer than k"):
        REF.knn(lattice[:10].double(), lattice[:3].double(), 16)


def test_the_reference_attention_is_a_per_query_loop():
    """The reference's blocked pair form against the published equations
    written out per query: the bins, the logit with the query scaled
    before the table term and the key term not, the value term."""
    gen = torch.Generator().manual_seed(2)
    heads, d, w = 2, 8, 5
    s = dict(REF.BASE, channels=[16], num_heads=[heads], window_sizes=[w])
    wts = REF.make_weights(dict(s, depths=[1]), 13, gen, "cpu")
    for kind in ("query", "key", "value"):  # tables large enough to weigh
        for sig in ("xyz", "rgb"):
            name = f"layers.0.blocks.0.attn.{kind}_{sig}_table"
            wts[name] = wts[name] * 20
    cells = torch.randint(0, 12, (80, 3), generator=gen).unique(dim=0)
    n = cells.shape[0]
    sig = torch.cat([cells.float() + 0.9 * torch.rand((n, 3), generator=gen),
                     (2 * torch.rand((n, 3), generator=gen) - 1) / 1.001], 1)
    lv = REF.Level(cells, cells.double(), 1)
    net = REF.Net(wts, [lv], [sig], s)
    x = torch.randn((n, 16), generator=gen)
    p = "layers.0.blocks.0.attn"
    got = net.attention(p, x, 0, heads, 2)
    qkv = (x @ wts[p + ".qkv.weight"].T + wts[p + ".qkv.bias"]).view(
        n, 3, heads, d)
    tab = {kind: torch.cat([wts[f"{p}.{kind}_xyz_table"].flatten(0, 1),
                            wts[f"{p}.{kind}_rgb_table"].flatten(0, 1)])
           for kind in ("query", "key", "value")}
    win = torch.div(cells + 2, w, rounding_mode="floor")
    out = torch.zeros((n, heads, d))
    for i in range(n):
        js = torch.nonzero((win == win[i]).all(1))[:, 0]
        rows = []
        for j in js.tolist():
            b = []
            for a in range(6):
                length, quant, off = ((40, 4.0, 40 * a) if a < 3 else
                                      (32, 8.0, 120 + 32 * (a - 3)))
                v = int(torch.floor((sig[i, a] - sig[j, a]) * quant)) + (
                    length // 2)
                b.append(off + min(max(v, 0), length - 1))
            rows.append(b)
        rows = torch.tensor(rows)  # (m, 6)
        qs = qkv[i, 0] * d ** -0.5
        kk, vv = qkv[js, 1], qkv[js, 2]
        e = ((qs[None] * kk).sum(-1)
             + (qs[None, None] * tab["query"][rows]).sum((1, -1))
             + (kk[:, None] * tab["key"][rows]).sum((1, -1)))  # (m, H)
        a_ = torch.softmax(e, dim=0)
        out[i] = (a_[..., None] * (vv + tab["value"][rows].sum(1))).sum(0)
    want = out.reshape(n, 16) @ wts[p + ".proj.weight"].T + wts[p + ".proj.bias"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _small(tiny):
    """Cut the tiny copy's Swin3D configuration to a backbone the CPU runs
    in seconds, head dim 8 and the published windows kept; scale factor 64,
    so that every level of the ~3,000-point cloud holds more than 16
    points."""
    path = os.path.join(tiny, "configs", "swin3d_thuman800k.json")
    with open(path) as f:
        d = json.load(f)
    d["cloud"]["scale_factor"] = d["pcml_info"]["scale_factor"] = 64
    d["pcml_info"].update({"depths": [1, 2, 2, 1, 1],
                           "channels": [16, 16, 32, 32, 32],
                           "num_heads": [2, 2, 4, 4, 4]})
    with open(path, "w") as f:
        json.dump(d, f)
    return tiny


def _run(root, manifest, wrap=None, device="cpu"):
    return harness.run(CELL, 2**31 + 27, 0.3, False, device=device,
                       root=root, manifest=manifest, wrap=wrap)


def test_the_cell_loads_and_the_sound_program_is_correct(tiny, manifest):
    cell = harness.load_cell(CELL, manifest=manifest)
    assert cell["config"]["renderer"] == "swin3d"
    assert cell["config"]["pcml_info"]["model_type"] == "swin3d"
    assert cell["config"]["reduced"] == []
    assert {m["name"] for m in cell["end_to_end"]} == {"request_ms",
                                                       "setup_s"}
    assert "swin_attn_roofline" in {m["name"] for m in cell["per_layer"]}
    mod = systems.load("swin3d")
    assert hasattr(mod, "Program") and hasattr(mod, "reference_splats")
    r = _run(_small(tiny), manifest)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["views_missing"]["value"] == 0


def _no_colour(t):
    rows = 3 * t.lp
    return t._replace(q=torch.cat([t.q[:rows], 0 * t.q[rows:]]),
                      k=torch.cat([t.k[:rows], 0 * t.k[rows:]]),
                      v=torch.cat([t.v[:rows], 0 * t.v[rows:]]))


def plant(fault, monkeypatch):
    """Plant ``fault`` in the program (the reference keeps its own code):
    "colour" drops cRSE's colour terms, "value" the value table, "shift"
    never shifts the windows, "tf32" runs the program's matmuls in TF32."""
    from gpcr_tpu_torch.models import swin3d as S3
    from gpcr_tpu_torch.ops import swin_attn
    from gpcr_tpu_torch.render import renderer as RD

    real_tables, real_partition = S3.WindowAttention.tables, \
        swin_attn.partition
    if fault == "colour":
        monkeypatch.setattr(S3.WindowAttention, "tables",
                            lambda self: _no_colour(real_tables(self)))
    elif fault == "value":
        monkeypatch.setattr(S3.WindowAttention, "tables", lambda self: (
            real_tables(self)._replace(v=0 * real_tables(self).v)))
    elif fault == "shift":
        monkeypatch.setattr(swin_attn, "partition",
                            lambda cells, w, shift: real_partition(cells, w, 0))
    else:
        def on():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        monkeypatch.setattr(RD, "pin_fp32", on)


@pytest.mark.parametrize("fault", ["colour", "value", "shift"])
def test_a_planted_fault_is_not_correct(tiny, manifest, monkeypatch, fault):
    plant(fault, monkeypatch)
    r = _run(_small(tiny), manifest)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, "colour", "value", "shift", "tf32"])
def test_planted_faults_on_the_card_at_the_cell_widths(card, tmp_path,
                                                       manifest, monkeypatch,
                                                       fault):
    """The cell as it runs (its cloud, widths, weights and limits), one
    request of 2 views checked: the sound program is correct, and each
    fault comes out not correct."""
    from cellbench import control

    root = str(tmp_path / "cellbench")
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    path = os.path.join(root, "traffic", "circle12.json")
    traffic = harness.load_json(path)
    traffic["views"] = 2
    with open(path, "w") as f:
        json.dump(traffic, f)
    if fault is not None:
        plant(fault, monkeypatch)
    line = control.readings(CELL, 2**31 + 41, ("program",), device="cuda",
                            root=root, manifest=manifest)[0]
    limits = harness.load_json(os.path.join(
        root, "workloads", CELL + ".json"))["limits"]
    bad = [key for key, lim in limits.items() if line[key] > lim]
    print(fault, json.dumps(line))
    assert bool(bad) == (fault is not None), (fault, line)

"""The PTv2 cell: ``gva_roofline``'s arithmetic on a hand-counted case and
on the folded least count (a kernel at the card's peak reads at most
100%), the reference's own fault checks (its brute-force kNN against an
exhaustive order, its GVA against a per-point loop), the system module
running the cell through the unchanged harness on the CPU at a tiny size,
and faults planted in the program (one wrong neighbour; the softmax over
the groups instead of the neighbours) coming out not correct."""

import json
import os

import pytest
import torch

from cellbench import harness, systems
from cellbench.measure import PEAKS
from cellbench.reference import ptv2 as REF

CELL = "ptv2_800k.circle12"
KERNEL = "void (anonymous namespace)::gva_kernel<64, 16>(Args)"


def _reader():
    return harness.load_reader("gva_roofline")


def test_gva_roofline_arithmetic():
    # one request: a launch bound by operations (67 GFLOP: 1 ms at 67
    # TFLOP/s) and one by bytes (3.35 GB: 1 ms at 3.35 TB/s); two profiled
    # requests take 8 ms of the kernel: 4 ms of bound, 50%
    work = [[67e9, 1e6], [1e3, 3.35e9]]
    ctx = harness.Ctx(completed=3, window_s=1.0, peaks=PEAKS["H100"],
                      timings=[{"model_time": 0.1, "gva_work": work}] * 3,
                      trace={"requests": 2, "busy_s": 0.02, "window_s": 0.03,
                             "by_name": {KERNEL: 0.008, "other": 1.0}})
    assert _reader()(ctx) == pytest.approx(50.0)


def test_gva_roofline_reads_nothing_where_nothing_is_there():
    read = _reader()
    base = dict(completed=1, window_s=1.0, peaks=PEAKS["H100"])
    trace = {"requests": 2, "busy_s": 0.02, "window_s": 0.03,
             "by_name": {KERNEL: 0.008}}
    work = [{"gva_work": [[1e9, 1e6]]}]
    assert read(harness.Ctx(**base, timings=work)) is None
    assert read(harness.Ctx(completed=1, window_s=1.0, timings=work,
                            trace=trace)) is None
    assert read(harness.Ctx(**base, timings=[{}], trace=trace)) is None
    assert read(harness.Ctx(**base, timings=work, trace=dict(
        trace, by_name={"patch_attn_kernel": 1.0}))) is None


@pytest.mark.parametrize("c,g,k", [(48, 6, 8), (48, 6, 16), (96, 12, 16),
                                   (384, 48, 16), (512, 64, 16)])
def test_the_least_count_keeps_the_share_at_or_under_100(c, g, k):
    """The folded count is below the unfolded form's (pe = W2 h per pair)
    at every width, so a kernel of either form that ran at the card's
    float32 peak on its own operations reads at most 100%; and a kernel
    that did exactly the least work at the peak reads exactly 100%."""
    n = 1000
    ops = REF.gva_least_ops(n, k, c, g)
    unfolded = n * k * (6 * c + 2 * c * c + 2 * c + 2 * g * c + 2 * g * g
                        + g + 2 * c) + n * 4 * c * c
    assert ops < unfolded
    peaks = PEAKS["H100"]
    work = [[ops, REF.gva_least_bytes(n, k, c, g)]]
    bound = max(ops / peaks["fp32_flops"],
                work[0][1] / peaks["hbm_bytes_per_s"])
    for kernel_s, want in ((bound, 100.0), (unfolded / peaks["fp32_flops"],
                                            None)):
        ctx = harness.Ctx(completed=1, window_s=1.0, peaks=peaks,
                          timings=[{"gva_work": work}],
                          trace={"requests": 1, "by_name": {
                              KERNEL: max(kernel_s, bound)}})
        share = _reader()(ctx)
        assert share <= 100.0 + 1e-9
        if want is not None:
            assert share == pytest.approx(want)


def test_the_reference_knn_is_the_exhaustive_order():
    """The screened brute force against ordering all n points of every
    query, on an integer lattice with many ties and on float means; each
    point its own first neighbour."""
    gen = torch.Generator().manual_seed(1)
    lattice = torch.stack(torch.meshgrid(*[torch.arange(8)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    for c in (lattice.double(),
              torch.rand((700, 3), generator=gen, dtype=torch.float64)):
        got = REF.knn(c, 16)
        d2 = ((c[:, None] - c[None]) ** 2).sum(-1)
        full = torch.arange(c.shape[0])[None].expand(c.shape[0], -1)
        assert torch.equal(got, REF._ordered(d2, full, 16))
        assert torch.equal(got[:, 0], torch.arange(c.shape[0]))
    with pytest.raises(ValueError, match="fewer than k"):
        REF.knn(lattice[:10].double(), 16)


def test_the_reference_attention_is_a_per_point_loop():
    """The reference's blocked, unfolded GVA against the published
    equations written out per point."""
    gen = torch.Generator().manual_seed(2)
    s = dict(REF.BASE, patch_embed_channels=16, patch_embed_groups=2)
    w = REF.make_weights(s, 13, gen, "cpu")
    c = torch.rand((60, 3), generator=gen, dtype=torch.float64) * 10
    lv = REF.Level(c, 16)
    net = REF.Net(w, [lv], s)
    x = torch.randn((60, 16), generator=gen)
    got = net.attention("patch_embed.blocks.0.attn", x, lv, 2, 8)

    def lin(p, t):
        return t @ w[p + ".weight"].T + w[p + ".bias"]

    p = "patch_embed.blocks.0.attn"
    q = torch.relu(net.batch_norm(p + ".norm_q", lin(p + ".linear_q", x)))
    kk = torch.relu(net.batch_norm(p + ".norm_k", lin(p + ".linear_k", x)))
    v = lin(p + ".linear_v", x)
    for i in range(60):
        out = torch.zeros(16)
        pe = lin(p + ".pe_fc2", torch.relu(net.batch_norm(
            p + ".pe_norm", lin(p + ".pe_fc1", lv.delta[i, :8]))))
        rel = kk[lv.nbr[i, :8]] - q[i] + pe
        wt = lin(p + ".we_fc2", torch.relu(net.batch_norm(
            p + ".we_norm", lin(p + ".we_fc1", rel))))
        a = torch.softmax(wt, dim=0)  # (8 neighbours, 2 groups)
        for g in range(2):
            chans = slice(8 * g, 8 * g + 8)
            out[chans] = (a[:, g:g + 1] * (v[lv.nbr[i, :8]] + pe)[:, chans]
                          ).sum(0)
        torch.testing.assert_close(got[i], out, rtol=0, atol=1e-5)


def _small(tiny):
    """Cut the tiny copy's PTv2 configuration to a backbone the CPU runs
    in a second, group width 8 kept; grid sizes (2, 4, 8, 16) and scale
    factor 32, so that every level of the ~3,000-point cloud holds more
    than 16 points and a voxel is about a pixel of the tiny views."""
    path = os.path.join(tiny, "configs", "ptv2_thuman800k.json")
    with open(path) as f:
        d = json.load(f)
    d["cloud"]["scale_factor"] = d["pcml_info"]["scale_factor"] = 32
    d["pcml_info"].update({
        "patch_embed_channels": 16, "patch_embed_groups": 2,
        "enc_channels": [16, 24, 32, 32], "enc_groups": [2, 3, 4, 4],
        "enc_depths": [1, 1, 1, 1], "dec_channels": [16, 16, 24, 32],
        "dec_groups": [2, 2, 3, 4], "grid_sizes": [2, 4, 8, 16]})
    with open(path, "w") as f:
        json.dump(d, f)
    return tiny


def _run(root, manifest, wrap=None):
    return harness.run(CELL, 2**31 + 23, 0.3, False, device="cpu",
                       root=root, manifest=manifest, wrap=wrap)


def test_the_cell_loads_and_the_sound_program_is_correct(tiny, manifest):
    cell = harness.load_cell(CELL, manifest=manifest)
    assert cell["config"]["renderer"] == "ptv2"
    assert cell["config"]["pcml_info"]["model_type"] == "ptv2"
    assert {m["name"] for m in cell["end_to_end"]} == {"request_ms",
                                                       "setup_s"}
    assert "gva_roofline" in {m["name"] for m in cell["per_layer"]}
    mod = systems.load("ptv2")
    assert hasattr(mod, "Program") and hasattr(mod, "reference_splats")
    r = _run(_small(tiny), manifest)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["views_missing"]["value"] == 0


def test_a_wrong_neighbour_is_not_correct(tiny, manifest, monkeypatch):
    """At every level of the program's plan, each point's first neighbour
    (itself) replaced by the point half the level away, its relative
    position kept."""
    from gpcr_tpu_torch.models import ptv2 as P2

    real = P2.PointTransformerV2.build_plan

    def faulty(self, grid):
        plan = real(self, grid)
        for lv in plan["levels"]:
            lv.nbr[:, 0] = torch.roll(lv.nbr[:, 0], lv.n // 2)
        return plan

    monkeypatch.setattr(P2.PointTransformerV2, "build_plan", faulty)
    r = _run(_small(tiny), manifest)
    assert not r["correct"], r["checks"]


def test_a_softmax_over_the_groups_is_not_correct(tiny, manifest):
    """The program's attention weights normalised over the groups of each
    neighbour instead of over the neighbours of each group (only while the
    program runs: the reference keeps torch's softmax)."""
    real = torch.softmax

    def faulty(t, dim, *a, **kw):
        return real(t, -1 if dim == 1 else dim, *a, **kw)

    def wrap(prog):
        def call(poses, timing):
            torch.softmax = faulty
            try:
                return prog(poses, timing)
            finally:
                torch.softmax = real
        return call

    r = _run(_small(tiny), manifest, wrap)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())

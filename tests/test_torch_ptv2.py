"""Point Transformer V2 as the learned renderer's backbone
(``gpcr_tpu_torch/models/ptv2.py``, ``ops/knn.py``, ``ops/gva.py``) on the
CPU, against the benchmark's plain reference ``cellbench/reference/ptv2.py``
(the same file the benchmark cell checks the program with).

The model: a small PTv2 on a seeded cloud of ~3.7K voxels (scale factor
64, so that the levels shrink as on the cell's cloud), channels 16-32 with
the group width kept at 8, grid sizes (2, 4, 8, 16) voxels so that every
level holds more than 16 points, the reference's seeded weights loaded by
name.

Tolerances: neighbour lists, relative positions and clusters are the same
numbers on both sides (the same float64 operations; integers compared
exactly). The plain GVA and the backbone at 2e-5 absolute on features of
rms ~0.2-1: the program computes the folded form (``ops/gva.py``) and the
reference the published unfolded one, float32 sums in other orders, a few
ulps per layer over 10 blocks. The splats and the rendered views as the
benchmark checks them (``image_mae`` 5e-5, ``hit_mae`` 1e-5).
"""

import dataclasses

import pytest
import torch

from cellbench.reference import network
from cellbench.reference import ptv2 as REF
from gpcr_tpu_torch.models import ptv2 as P2
from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                           assemble_input_features)
from gpcr_tpu_torch.ops import gva, knn, sparse
from gpcr_tpu_torch.render import renderer as RD
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.utils import trace

# one intra-op thread: see tests/test_torch_render.py
torch.set_num_threads(1)
pin_fp32()

SMALL = {
    "in_channels": 9, "patch_embed_depth": 1, "patch_embed_channels": 16,
    "patch_embed_groups": 2, "patch_embed_neighbours": 8,
    "enc_depths": [1, 1, 2, 1], "enc_channels": [16, 24, 32, 32],
    "enc_groups": [2, 3, 4, 4], "enc_neighbours": [16, 16, 16, 16],
    "dec_depths": [1, 1, 1, 1], "dec_channels": [16, 16, 24, 32],
    "dec_groups": [2, 2, 3, 4], "dec_neighbours": [16, 16, 16, 16],
    "grid_sizes": [2, 4, 8, 16],
}
SF = 64
HEAD = dict(sh_deg=1, sh_feat_deg=0, use_rotation=True, use_scale=True,
            use_offset=True, use_dc_offset=False, use_opacity=False,
            est_normal=True, normalize_normal=True, enable_opacity=True,
            scale_factor=SF)
INFO = dict(HEAD, model_type="ptv2", clr_encoder_channels="9", **SMALL)
CLOUD = {"points": 4000, "scale_factor": SF, "offset": 512, "grid": 1024,
         "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
SEED = 2**31 + 29
TOL = 2e-5


def _cloud():
    from cellbench import scene

    return scene.cloud(CLOUD, SEED, "cpu")


def _weights():
    from cellbench import scene

    return REF.make_weights(REF.settings(SMALL), 13, scene.generator(
        SEED, scene.STREAM_WEIGHTS, "cpu"), "cpu")


@pytest.fixture(scope="module")
def small():
    """(coords, rgb, reference weights, program encoder, grid, plan, the
    reference's levels)."""
    xyz, rgb = _cloud()
    w = _weights()
    enc = PCEncoder(INFO, generator=torch.Generator().manual_seed(0)).eval()
    enc.color_encoder.load_state_dict(w)
    info = PCMLInfo.from_dict(INFO)
    grid = sparse.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    with torch.no_grad():
        plan = enc.build_plan(grid)
        vox, _ = network.voxelize(xyz, rgb)
        levels = REF.hierarchy(vox, REF.settings(SMALL))
    return xyz, rgb, w, enc, grid, plan, levels


# ---- geometry ---------------------------------------------------------------


def _lattice(n=10):
    r = torch.arange(n)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("cloud", ["lattice", "scatter", "means"])
def test_knn_is_the_brute_force_order(cloud, k):
    """The grid search against the reference's brute force: an integer
    lattice (ties at every distance, the smaller index first), a sparse
    integer scatter beside a dense block (cells widened several times) and
    float means; each point its own first neighbour."""
    gen = torch.Generator().manual_seed(k)
    if cloud == "lattice":
        c = _lattice().double()
    elif cloud == "scatter":
        c = torch.unique(torch.cat([_lattice(6), torch.randint(
            0, 120, (300, 3), generator=gen)]), dim=0).double()
    else:
        c = REF.grid_pool(_lattice(12).double() + torch.rand(
            (1728, 3), generator=gen, dtype=torch.float64), 3.0)[1]
    with trace.recording() as rec:
        got = knn.knn(c, k, 3.0)
    assert torch.equal(got, REF.knn(c, k))
    assert torch.equal(got[:, 0], torch.arange(c.shape[0]))
    counted = rec.counters[None]  # outside a request
    assert counted["knn_queries"] == c.shape[0]
    assert counted["knn_candidates"] >= k * c.shape[0]


def test_knn_refuses_a_level_below_k():
    with pytest.raises(ValueError, match="fewer than k"):
        knn.knn(_lattice(2).double(), 16, 3.0)
    with pytest.raises(TypeError, match="float64"):
        knn.knn(_lattice(3).float(), 16, 3.0)


def test_grid_pool_matches_the_reference():
    gen = torch.Generator().manual_seed(4)
    c = _lattice(14).double()[torch.randperm(14 ** 3, generator=gen)[:1500]]
    for size in (2.0, 3.0, 5.0):
        got, want = P2.grid_pool(c, size), REF.grid_pool(c, size)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        c = got[1]  # the next level pools float means
    # each cluster's mean lies in its cell: clusters keep their ids' order
    cluster, means = P2.grid_pool(_lattice(6).double(), 3.0)
    assert means.shape == (8, 3) and cluster.max() == 7
    assert torch.equal(means[0], torch.tensor([1.0, 1.0, 1.0],
                                              dtype=torch.float64))


def test_the_plan_is_the_reference_geometry(small):
    *_, plan, levels = small
    assert [lv.n for lv in plan["levels"]] == [lv.n for lv in levels]
    assert all(lv.n >= 16 for lv in levels) and levels[-1].n < levels[0].n
    for got, want in zip(plan["levels"], levels):
        assert got.nbr.dtype == torch.int32
        assert torch.equal(got.nbr.long(), want.nbr)
        assert torch.equal(got.delta, want.delta)
        if want.cluster is not None:
            assert torch.equal(got.cluster, want.cluster)
            assert got.n_next == int(want.cluster.max()) + 1


def test_a_level_below_k_is_refused(small):
    *_, enc, grid, _, _ = small
    cfg = dataclasses.replace(enc.color_encoder.cfg,
                              grid_sizes=(2, 4, 8, 64))
    model = P2.PointTransformerV2(cfg, 13, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="fewer than k"):
        model.build_plan(grid)


# ---- the attention ----------------------------------------------------------


@pytest.mark.parametrize("k", [8, 16])
def test_the_plain_gva_is_the_reference_attention(small, k):
    """The folded plain path against the reference's unfolded GVA at the
    patch embedding's level and width, on seeded BN statistics."""
    *_, w, enc, grid, plan, levels = small
    attn = enc.color_encoder.patch_embed.blocks[0].attn
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((grid.num, 16), generator=gen)
    net = REF.Net(w, levels, REF.settings(SMALL))
    with torch.no_grad():
        want = net.attention("patch_embed.blocks.0.attn", x, levels[0], 2, k)
        got = attn(x, plan["levels"][0], k)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_the_kernel_refuses_what_it_does_not_take(small):
    *_, enc, _, plan, _ = small
    lv = plan["levels"][0]
    f = enc.color_encoder.patch_embed.blocks[0].attn.folded()
    q = torch.zeros((lv.n, 16))
    with pytest.raises(ValueError, match="groups"):
        gva.check_gva_inputs(q, q, q, lv.nbr, lv.delta, 16, f)  # 2 groups
    big = P2.GroupedVectorAttention(96, 12, torch.Generator().manual_seed(1))
    f = big.eval().folded()
    q = torch.zeros((lv.n, 96))
    assert gva.check_gva_inputs(q, q, q, lv.nbr, lv.delta, 16, f) == 12
    with pytest.raises(ValueError, match="8 at 6 groups"):
        gva.check_gva_inputs(q, q, q, lv.nbr, lv.delta, 8, f)
    with pytest.raises(ValueError, match="int32"):
        gva.check_gva_inputs(q, q, q, lv.nbr.long(), lv.delta, 16, f)


# ---- the model --------------------------------------------------------------


def test_backbone_matches_the_reference(small):
    xyz, rgb, w, enc, grid, plan, _ = small
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
        _, _, want, net, _ = REF.backbone(xyz, rgb, w, REF.settings(SMALL), SF)
    assert got.shape == (grid.num, 16) and float(want.std()) > 0.1
    assert len(net.launches) == 10
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def _backbone_error(small, wrap_attention=None, plan=None):
    xyz, rgb, w, enc, grid, plan0, _ = small
    real = gva.grouped_vector_attention
    if wrap_attention is not None:
        gva.grouped_vector_attention = wrap_attention(real)
    try:
        with torch.no_grad():
            got = enc.color_encoder.backbone(grid, plan or plan0)
    finally:
        gva.grouped_vector_attention = real
    with torch.no_grad():
        want = REF.backbone(xyz, rgb, w, REF.settings(SMALL), SF)[2]
    return float((got - want).abs().max())


def test_a_wrong_neighbour_fails_the_comparison(small):
    """One neighbour of every point at level 0 (the last, the farthest)
    replaced by the point half the level away, its relative position
    kept."""
    *_, plan, _ = small
    lv = plan["levels"][0]
    nbr = lv.nbr.clone()
    nbr[:, -1] = torch.roll(nbr[:, -1], lv.n // 2)
    bad = {"levels": [dataclasses.replace(lv, nbr=nbr)]
           + plan["levels"][1:]}
    assert _backbone_error(small, plan=bad) > 10 * TOL


def test_a_softmax_over_the_groups_fails_the_comparison(small):
    """The attention weights normalised over each neighbour's groups
    instead of over each group's neighbours."""
    def wrap(real):
        def faulty(q, k, v, nbr, delta, neighbours, f):
            keep = torch.softmax
            torch.softmax = lambda t, dim: keep(t, dim=-1)
            try:
                return real(q, k, v, nbr, delta, neighbours, f)
            finally:
                torch.softmax = keep
        return faulty

    assert _backbone_error(small, wrap) > 10 * TOL


def test_config_and_state_dict_keys():
    info = PCMLInfo.from_dict(INFO)
    assert info.ptv2 == P2.PTv2Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in SMALL.items()})
    assert info.ptv3 is None
    # a ptv2 info without widths holds the base configuration
    assert PCMLInfo(model_type="ptv2", clr_encoder_channels="9").ptv2 == (
        P2.PTv2Config())
    assert PCMLInfo.from_dict(dict(INFO, model_type="unet")).ptv2 is None
    model = P2.PointTransformerV2(P2.PTv2Config(), 13,
                                  torch.Generator().manual_seed(0))
    specs = REF.param_specs(REF.settings({}), 13)
    state = model.state_dict()
    assert [n for n, *_ in specs] == list(state)
    assert all(tuple(state[n].shape) == shape for n, shape, *_ in specs)
    # Pointcept's m2 base: 11.26M parameters without BatchNorm's affine
    # pairs (the paper's 11.3M), 17 blocks a pass
    params = dict(model.named_parameters())
    assert sum(p.numel() for n, p in params.items()
               if "norm" not in n) == 11260933
    assert sum(len(s.blocks) for s in [model.patch_embed, *model.enc,
                                       *model.dec]) == 17
    assert model.cfg.level_neighbours() == [16, 16, 16, 16, 16]


# ---- on the renderer's path -------------------------------------------------


def _cell_config():
    return {"pcml_info": INFO, "cloud": CLOUD, "background": 0.0,
            "raster": {"dup_cap": 256, "chunk": 256, "k_budget": None,
                       "max_active": None, "opacity_radius": True}}


def test_render_matches_the_reference_raster():
    """One ``PCMLRender(model_type "ptv2")`` request of 2 views through the
    benchmark's system module, every view against the reference's splats
    rasterized by the reference, as the cell checks it."""
    from cellbench import harness, scene, systems

    cfg = _cell_config()
    traffic = {"views": 2, "width": 32, "height": 32, "supersample": 2,
               "fov_deg": 45.0, "ring_radius": 3.0}
    system = systems.load("ptv2")
    inputs = system.make_inputs(cfg, SEED, "cpu")
    prog = system.Program(cfg, traffic, inputs, "cpu")
    poses = scene.Cameras(traffic, SEED, "cpu").request(0)
    timing = {}
    with harness.quiet():
        out = prog(poses, timing)
    assert len(timing["gva_work"]) == 2 * 10
    with torch.no_grad():
        ref = system.reference_splats(cfg, inputs)
        worst, _ = harness.check({"traffic": traffic, "config": cfg},
                                 [(0, poses, out)], ref, system, "cpu")
    assert worst["views_missing"] == 0
    assert worst["image_mae"] <= 5e-5 and worst["hit_mae"] <= 1e-5, worst
    assert float(out["hitmap"].amax()) > 0


def test_render_spans_and_counters():
    xyz, rgb = _cloud()
    cam = RD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                           "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                           "center_angles": [90, 0]})
    from gpcr_tpu_torch.ops import rasterize as R

    rdr = RD.PCMLRender(info=INFO, voxelized=True, scale_factor=SF,
                        config=R.RasterizeConfig(max_dup_per_gaussian=256,
                                                 chunk_size=256,
                                                 opacity_radius=True),
                        device="cpu")
    pcd = PointCloud(xyz_w=xyz[None], rgb=rgb[None])
    with trace.recording() as rec:
        for _ in range(2):
            rdr.render(pcd, None, cam, 45, background_color=0.0)
    names = {s.name for s in rec.spans}
    for child in ("", ".embed", ".gva", ".pool", ".unpool", ".head"):
        assert "gpcr.encode.ptv2" + child in names
    assert {"gpcr.encode.plan.knn", "gpcr.encode.plan.grid"} <= names
    assert "gpcr.encode.unet" not in names
    first, second = rec.counters[0], rec.counters[1]
    assert first["plan_builds"] == 1 and second["plan_hits"] == 2
    assert first["knn_queries"] > 0 and "knn_queries" not in second
    with torch.no_grad():
        ref = REF.splats(xyz, rgb, _weights(), REF.settings(SMALL), SF)
    for c in (first, second):  # two encodes per request
        assert c["gva_launches"] == 2 * 10
        assert c["gva_pairs"] == 2 * ref["gva_pairs"]

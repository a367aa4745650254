"""Point Transformer V3 as the learned renderer's backbone
(``gpcr_tpu_torch/models/ptv3.py``, ``ops/serialize.py``,
``ops/patch_attn.py``) on the CPU, against the benchmark's plain reference
``cellbench/reference/ptv3.py`` (the same file the benchmark cell checks the
program with).

The model: a small PTv3 on a seeded cloud of ~3K voxels, channels (8, 16,
16, 32, 32), head dim 8, patch size 64, encoder depths (2, 1, 1, 4, 1) so
that stage 3 runs all four orders, decoder depths (1, 1, 1, 1), the
reference's seeded weights loaded by name.

Tolerances: codes, orders, patches, clusters and maps are integers and
equal. The backbone output at 2e-5 absolute on features of rms ~1.5: the
two sides sum the same float32 terms in other orders (index_add over pairs
against gather-GEMM over offsets, another batching of the attention
products), which moves a feature by a few float32 ulps per layer over
~20 layers. The splats at 1e-4 absolute: the head and the normalisation
scale those differences up by at most a few times.
"""

import dataclasses

import pytest
import torch

from cellbench.reference import ptv3 as REF
from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                           assemble_input_features)
from gpcr_tpu_torch.models.ptv3 import PointTransformerV3, PTv3Config
from gpcr_tpu_torch.ops import patch_attn, serialize, sparse
from gpcr_tpu_torch.render import renderer as RD
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.utils import trace

# one intra-op thread: see tests/test_torch_render.py
torch.set_num_threads(1)
pin_fp32()

SMALL = {
    "in_channels": 9, "patch_size": 64,
    "enc_channels": [8, 16, 16, 32, 32], "enc_heads": [1, 2, 2, 4, 4],
    "enc_depths": [2, 1, 1, 4, 1],
    "dec_channels": [16, 16, 16, 32], "dec_heads": [2, 2, 2, 4],
    "dec_depths": [1, 1, 1, 1],
}
HEAD = dict(sh_deg=1, sh_feat_deg=0, use_rotation=True, use_scale=True,
            use_offset=True, use_dc_offset=False, use_opacity=False,
            est_normal=True, normalize_normal=True, enable_opacity=True,
            scale_factor=448)
INFO = dict(HEAD, model_type="ptv3", clr_encoder_channels="9", **SMALL)
CLOUD = {"points": 3500, "scale_factor": 448, "offset": 512, "grid": 1024,
         "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
SEED = 2**31 + 29


def _cloud():
    from cellbench import scene

    return scene.cloud(CLOUD, SEED, "cpu")


@pytest.fixture(scope="module")
def small():
    """(coords, rgb, reference weights, program encoder, grid, plan)."""
    from cellbench import scene

    xyz, rgb = _cloud()
    w = REF.make_weights(REF.settings(SMALL), 13,
                         scene.generator(SEED, scene.STREAM_WEIGHTS, "cpu"),
                         "cpu")
    enc = PCEncoder(INFO, generator=torch.Generator().manual_seed(0)).eval()
    enc.color_encoder.load_state_dict(w)
    info = PCMLInfo.from_dict(INFO)
    grid = sparse.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    with torch.no_grad():
        plan = enc.build_plan(grid)
    return xyz, rgb, w, enc, grid, plan


def _grid16():
    r = torch.arange(16)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


# ---- serialization ----------------------------------------------------------


@pytest.mark.parametrize("order", serialize.ORDERS)
def test_codes_are_a_bijection_and_match_the_reference(order):
    g = _grid16()
    code = serialize.encode(g, order, 4)
    assert torch.equal(torch.sort(code).values, torch.arange(16 ** 3))
    assert torch.equal(code, REF.encode(g, order, 4))
    # a pooled level's codes: the children's >> 3 are the parents' groups
    parent = (g >> 1)
    key = (parent[:, 0] * 8 + parent[:, 1]) * 8 + parent[:, 2]
    by_code = torch.unique(code >> 3, return_inverse=True)[1]
    by_parent = torch.unique(key, return_inverse=True)[1]
    pairs = torch.unique(torch.stack([by_code, by_parent]), dim=1)
    assert pairs.shape[1] == 8 ** 3  # one parent per code group and back


@pytest.mark.parametrize("order", ["hilbert", "hilbert-trans"])
def test_successive_hilbert_codes_are_face_neighbours(order):
    g = _grid16()
    code = serialize.encode(g, order, 4)
    walk = g[torch.argsort(code)]
    steps = (walk[1:] - walk[:-1]).abs().sum(dim=1)
    assert bool((steps == 1).all())


def test_morton_bit_layout():
    g = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [2, 0, 0],
                      [5, 3, 6]])
    assert serialize.morton(g, 3).tolist() == [4, 2, 1, 32, 0b101011110]


# ---- patches and clusters -------------------------------------------------


@pytest.mark.parametrize("n,k", [(200, 64), (192, 64), (50, 50), (1, 1)])
def test_last_patch_is_the_last_k_points(n, k):
    gen = torch.Generator().manual_seed(n)
    code = torch.randperm(10 * n, generator=gen)[:n]
    pt = serialize.patches_of(code, 64)
    assert pt.k == k and pt.patches == -(-n // k)
    order = torch.argsort(code)
    slots = pt.pad_rows.view(pt.patches, k)
    assert torch.equal(slots[-1], order[n - k:])
    assert torch.equal(slots[:-1].reshape(-1), order[:(pt.patches - 1) * k])
    # each voxel keeps one slot: its own; the last patch keeps only the
    # r = n mod k points no earlier patch holds
    assert torch.equal(pt.pad_rows[pt.unpad_slots], torch.arange(n))
    kept_last = int((pt.unpad_slots >= (pt.patches - 1) * k).sum())
    assert kept_last == (n % k if n % k else k)
    assert pt.pad_rows_shared == pt.patches * k - n


def test_pooling_clusters_are_the_parents(small):
    *_, plan = small
    for lv, nxt in zip(plan["levels"][:-1], plan["levels"][1:]):
        coords = lv.grid.coords()
        assert torch.equal(nxt.grid.coords()[lv.parent], coords >> 1)
        # Pointcept's clusters (code_z >> 3) group the voxels as the parents
        _, cluster = torch.unique(serialize.morton(coords, 10) >> 3,
                                  return_inverse=True)
        n = int(cluster.max()) + 1
        assert n == nxt.grid.num
        pairs = torch.unique(torch.stack([cluster, lv.parent]), dim=1)
        assert pairs.shape[1] == n


def test_the_plan_matches_the_reference_hierarchy(small):
    xyz, rgb, *_, plan = small
    vox, _ = REF.voxelize(xyz, rgb)
    levels, depth = REF.hierarchy(vox, REF.settings(SMALL))
    assert depth == plan["depth"]
    for ref, lv in zip(levels, plan["levels"]):
        assert ref.n == lv.grid.num
        # the same voxels (the reference orders pooled levels by code)
        key = lambda c: (c[:, 0] * 1024 + c[:, 1]) * 1024 + c[:, 2]
        assert torch.equal(torch.sort(key(ref.g)).values,
                           key(lv.grid.coords()))
        for o, pt in enumerate(lv.patches):
            assert pt.k == ref.k and pt.patches == ref.patches
            assert torch.equal(key(lv.grid.coords())[pt.order.long()],
                               key(ref.g)[ref.order[o]])


# ---- the stem ---------------------------------------------------------------


def test_125_offset_stem_matches_a_plain_sum(small):
    _, _, w, enc, grid, plan = small
    kernel = w["embedding.conv.kernel"]
    with torch.no_grad():
        got = sum(sparse.conv_map(m, [grid.feats],
                                  [kernel[25 * i:25 * i + 25]], [None])[0]
                  for i, m in enumerate(plan["stem"]))
    coords = grid.coords()
    want = torch.zeros_like(got)
    for o, (rows, nbr) in enumerate(REF.neighbour_pairs(coords, 5)):
        want.index_add_(0, rows, grid.feats[nbr] @ kernel[o])
    assert len(plan["stem"]) == 5
    assert all(m.kmap.shape == (grid.num, 25) for m in plan["stem"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---- the model --------------------------------------------------------------


def test_backbone_matches_the_reference(small):
    xyz, rgb, w, enc, grid, plan = small
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
        _, _, want, net = REF.backbone(xyz, rgb, w, REF.settings(SMALL), 448)
    assert got.shape == (grid.num, 16)
    assert net.attn_patches > 0 and float(want.std()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_splats_match_the_reference(small):
    xyz, rgb, w, enc, grid, plan = small
    with torch.no_grad():
        sp = enc(grid, plan)
        ref = REF.splats(xyz, rgb, w, REF.settings(SMALL), 448)
    for got, want in ((sp.primitives, ref["xyz"]),
                      (sp.rotation, ref["rotation"]),
                      (sp.scale, ref["scale"]), (sp.normal, ref["normal"]),
                      (sp.sh[:, :4], ref["sh"])):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_the_plain_attention_is_the_reference_attention(small):
    *_, plan = small
    lv = plan["levels"][1]
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((lv.grid.num, 48), generator=gen)
    for o, pt in enumerate(lv.patches):
        got = patch_attn.patch_attention_plain(qkv, pt, 2)
        # per patch, one softmax over the patch's rows
        want = torch.empty_like(got)
        order = pt.order.long()
        for p in range(pt.patches):
            s = min(p * pt.k, pt.n - pt.k)
            rows = order[s:s + pt.k]
            t = qkv[rows].view(pt.k, 3, 2, 8).permute(1, 2, 0, 3)
            a = torch.softmax(t[0] @ t[1].transpose(-1, -2) / 8 ** 0.5, -1)
            keep = rows[max(0, p * pt.k - s):]
            want[keep] = (a @ t[2]).transpose(0, 1).reshape(pt.k, 16)[
                max(0, p * pt.k - s):]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_attention_work_counts_the_queries_the_function_needs(small):
    """The benchmark's attention work (what ``attn_roofline`` divides by):
    per block, (4 d + 1) K per query and head over the N queries of its
    level, and the same levels, patch sizes and point counts as the
    program's plan; where N mod K > 0 the K - r shared rows of the last
    patch, which the kernel computes and drops, are not counted."""
    xyz, *_, plan = small
    s = REF.settings(SMALL)
    want = []
    for depths, heads, chans in ((s["enc_depths"], s["enc_heads"],
                                  s["enc_channels"]),
                                 (s["dec_depths"], s["dec_heads"],
                                  s["dec_channels"])):
        for st, depth in enumerate(depths):
            pt = plan["levels"][st].patches[0]
            h, d = heads[st], chans[st] // heads[st]
            want += [[(4 * d + 1) * pt.k * pt.n * h,
                      4 * h * d * (2 * pt.patches * pt.k + 2 * pt.n)]] * depth
    work = REF.attention_work(xyz, s)
    assert work == want
    padded = [lv.patches[0] for lv in plan["levels"]
              if lv.patches[0].pad_rows_shared]
    assert padded  # the small cloud has levels with a shared last patch
    for pt in padded:
        assert pt.k * pt.n < pt.k * pt.k * pt.patches


def test_the_kernel_refuses_what_it_does_not_take(small):
    *_, plan = small
    pt = plan["levels"][0].patches[0]
    with pytest.raises(ValueError, match="head dim"):
        patch_attn.check_attn_inputs(torch.zeros((pt.n, 48)), pt, 2)  # d 8
    assert patch_attn.check_attn_inputs(torch.zeros((pt.n, 96)), pt, 2) == 16
    with pytest.raises(ValueError, match="points"):
        patch_attn.check_attn_inputs(torch.zeros((pt.n + 1, 96)), pt, 2)
    with pytest.raises(TypeError, match="int32"):
        patch_attn.check_attn_inputs(torch.zeros((pt.n, 96)),
                                     dataclasses.replace(
                                         pt, order=pt.order.long()), 2)


def test_config_and_state_dict_keys():
    info = PCMLInfo.from_dict(INFO)
    assert info.ptv3 == PTv3Config(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in SMALL.items()})
    # a ptv3 info without widths holds the base configuration
    assert PCMLInfo(model_type="ptv3", clr_encoder_channels="9").ptv3 == (
        PTv3Config())
    assert PCMLInfo.from_dict(dict(INFO, model_type="unet")).ptv3 is None
    model = PointTransformerV3(PTv3Config(), 13,
                               torch.Generator().manual_seed(0))
    specs = REF.param_specs(REF.settings({}), 13)
    state = model.state_dict()
    assert [n for n, *_ in specs] == list(state)
    assert all(tuple(state[n].shape) == shape for n, shape, *_ in specs)
    # Pointcept's base configuration: ~46M parameters
    assert sum(p.numel() for p in model.parameters()) == 46183149 - sum(
        state[n].numel() for n in state if "running" in n)
    with pytest.raises(NotImplementedError):
        PCEncoder(dict(INFO, model_type="pointnet"))


# ---- on the renderer's path, traced -----------------------------------------


def test_render_spans_and_counters():
    xyz, rgb = _cloud()
    cam = RD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                           "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                           "center_angles": [90, 0]})
    from gpcr_tpu_torch.ops import rasterize as R

    rdr = RD.PCMLRender(info=INFO, voxelized=True, scale_factor=448,
                        config=R.RasterizeConfig(max_dup_per_gaussian=256,
                                                 chunk_size=256,
                                                 opacity_radius=True),
                        device="cpu")
    pcd = PointCloud(xyz_w=xyz[None], rgb=rgb[None])
    with trace.recording() as rec:
        for _ in range(2):
            rdr.render(pcd, None, cam, 45, background_color=0.0)
    names = {s.name for s in rec.spans}
    for child in ("", ".stem", ".cpe", ".attn", ".mlp", ".pool", ".unpool"):
        assert "gpcr.encode.ptv3" + child in names
    assert "gpcr.encode.plan.serialize" in names
    assert "gpcr.encode.unet" not in names
    first, second = rec.counters[0], rec.counters[1]
    assert first["plan_builds"] == 1 and second["plan_hits"] == 2
    with torch.no_grad():
        ref = REF.splats(xyz, rgb, REF.make_weights(
            REF.settings(SMALL), 13, torch.Generator().manual_seed(1),
            "cpu"), REF.settings(SMALL), 448)
    for c in (first, second):  # two encodes per request
        assert c["attn_pairs"] == 2 * ref["attn_pairs"]
        assert c["attn_patches"] == 2 * ref["attn_patches"]
        assert c["attn_pad_rows"] >= 0

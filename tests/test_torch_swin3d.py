"""Swin3D as the learned renderer's backbone (``gpcr_tpu_torch/models/
swin3d.py``, ``ops/swin_attn.py``, ``ops/knn.py``'s cross-set queries) on
the CPU, against the benchmark's plain reference
``cellbench/reference/swin3d.py`` (the same file the benchmark cell checks
the program with).

The model: a small Swin3D on a seeded cloud of ~2.8K voxels (scale factor
64, so that the levels shrink as on the cell's cloud, to ~45 points at
level 4), channels 16-32 in heads of 8 (the published level-0
head dim), the published windows (5, 7, 7, 7, 7) and quant size 4, the
reference's seeded weights loaded by name.

Tolerances: cells, positions, kNN lists and interpolation weights are the
same numbers on both sides (the same float64 operations; integers
compared exactly). The plain attention and the backbone at 2e-5 absolute
on features of rms ~0.5-1: the program computes the per-point dots and a
value histogram (``ops/swin_attn.py``), the reference gathers every
pair's table rows, float32 sums in other orders over 10 blocks. The
splats and the rendered views as the benchmark checks them
(``image_mae`` 5e-5, ``hit_mae`` 1e-5).
"""

import dataclasses

import pytest
import torch

from cellbench.reference import network
from cellbench.reference import swin3d as REF
from gpcr_tpu_torch.models import swin3d as S3
from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                           assemble_input_features)
from gpcr_tpu_torch.ops import knn, sparse, swin_attn
from gpcr_tpu_torch.render import renderer as RD
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.utils import trace

# one intra-op thread: see tests/test_torch_render.py
torch.set_num_threads(1)
pin_fp32()

SMALL = {"depths": [1, 2, 2, 1, 1], "channels": [16, 16, 32, 32, 32],
         "num_heads": [2, 2, 4, 4, 4]}
SF = 64
HEAD = dict(sh_deg=1, sh_feat_deg=0, use_rotation=True, use_scale=True,
            use_offset=True, use_dc_offset=False, use_opacity=False,
            est_normal=True, normalize_normal=True, enable_opacity=True,
            scale_factor=SF)
INFO = dict(HEAD, model_type="swin3d", clr_encoder_channels="9", **SMALL)
CLOUD = {"points": 3000, "scale_factor": SF, "offset": 512, "grid": 1024,
         "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
SEED = 2**31 + 31
TOL = 2e-5
# Swin3D-S with the 13-channel classifier, measured on the model: every
# parameter (LayerNorm and BatchNorm affine pairs included), and the cRSE
# tables among them
PARAMETERS, TABLE_PARAMETERS = 26499661, 4731264


def _cloud():
    from cellbench import scene

    return scene.cloud(CLOUD, SEED, "cpu")


def _weights():
    from cellbench import scene

    return REF.make_weights(REF.settings(SMALL), 13, scene.generator(
        SEED, scene.STREAM_WEIGHTS, "cpu"), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's backbone output and its pass's ``Net``."""
    xyz, rgb = _cloud()
    with torch.no_grad():
        _, _, want, net, _ = REF.backbone(xyz, rgb, _weights(),
                                          REF.settings(SMALL), SF)
    return want, net


@pytest.fixture(scope="module")
def small():
    """(coords, rgb, reference weights, program encoder, grid, plan, the
    reference's levels, the reference's signals)."""
    xyz, rgb = _cloud()
    w = _weights()
    enc = PCEncoder(INFO, generator=torch.Generator().manual_seed(0)).eval()
    enc.color_encoder.load_state_dict(w)
    info = PCMLInfo.from_dict(INFO)
    grid = sparse.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    with torch.no_grad():
        plan = enc.build_plan(grid)
        vox, feats = network.voxelize(xyz, network.input_features(
            xyz, rgb, SF))
        levels = REF.hierarchy(vox, REF.settings(SMALL))
        sig = REF.signals(levels, feats[:, -3:])
    return xyz, rgb, w, enc, grid, plan, levels, sig


# ---- geometry ---------------------------------------------------------------


def _lattice(n=10):
    r = torch.arange(n)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("cloud", ["lattice", "means"])
def test_cross_set_knn_is_the_brute_force_order(cloud, k):
    """Queries of another set against the reference's brute force: a
    lattice's cell centres among its points (ties at every distance, the
    smaller index first) and a fine set among its grid means (queries
    outside the points' box, cells widened several times)."""
    gen = torch.Generator().manual_seed(k)
    if cloud == "lattice":
        pts = _lattice(8).double()
        qs = torch.unique(torch.div(_lattice(8), 2, rounding_mode="floor"),
                          dim=0).double() * 2 + 0.5
    else:
        pts = _lattice(12).double() + torch.rand((1728, 3), generator=gen,
                                                 dtype=torch.float64)
        qs, pts = pts, S3.ordered_mean(pts, S3.members_table(
            S3.grid_cluster(torch.floor(pts), 3.0, 0.0)))
    with trace.recording() as rec:
        got = knn.knn(pts, k, 3.0, qs)
    assert torch.equal(got, REF.knn(pts, qs, k))
    counted = rec.counters[None]
    assert counted["knn_queries"] == qs.shape[0]
    assert counted["knn_candidates"] >= k * qs.shape[0]


def test_self_knn_lists_are_the_cross_set_lists_and_the_brute_force():
    """A set's own lists (Point Transformer V2's plan) are its lists as
    queries of itself, and the reference's brute force."""
    from cellbench.reference import ptv2 as P2REF

    gen = torch.Generator().manual_seed(9)
    c = torch.unique(torch.cat([_lattice(6), torch.randint(
        0, 90, (400, 3), generator=gen)]), dim=0).double()
    own = knn.knn(c, 16, 3.0)
    assert torch.equal(own, knn.knn(c, 16, 3.0, c.clone()))
    assert torch.equal(own, P2REF.knn(c, 16))
    with pytest.raises(TypeError, match="float64"):
        knn.knn(c, 16, 3.0, c.float())


@pytest.mark.parametrize("shift", [0, 3])
def test_the_partition_is_the_reference_windows(shift):
    """Each window's points, in ascending index order, as the reference
    groups them (windows in another order); the chunks cover every query
    of every window once, 32 at most."""
    gen = torch.Generator().manual_seed(shift)
    cells = torch.unique(torch.cat([_lattice(7), torch.randint(
        0, 60, (500, 3), generator=gen)]), dim=0)
    win = swin_attn.partition(cells, 7, shift)
    rows, counts = REF.windows(cells, 7, shift)
    got = {tuple(win.perm[int(a):int(b)].tolist())
           for a, b in zip(win.offsets[:-1], win.offsets[1:])}
    want = {tuple(r[r >= 0].tolist()) for r in rows}
    assert got == want and win.count == len(want)
    assert win.most == int(counts.max()) and win.pairs == int(
        (counts * counts).sum())
    assert win.most == (343 if shift == 0 else win.most)
    ch = win.chunks.long()
    assert bool((ch[:, 2] < ch[:, 1]).all()) and bool((ch[:, 2] % 32 == 0).all())
    assert int(torch.minimum(ch[:, 1] - ch[:, 2], torch.tensor(32)).sum()) == (
        cells.shape[0])


def test_the_plan_is_the_reference_geometry(small):
    *_, plan, levels, sig = small
    assert [lv.n for lv in plan["levels"]] == [lv.n for lv in levels]
    assert levels[-1].n >= 16 and levels[-1].n < levels[0].n
    for got, want in zip(plan["levels"], levels):
        assert torch.equal(got.cells, want.cells)
        assert torch.equal(got.pos, want.pos)
        if want.down is not None:
            assert torch.equal(got.down_nbr, want.down)
        if want.up is not None:
            assert torch.equal(got.up_nbr, want.up)
            assert torch.equal(got.up_w, want.up_w)
    _, _, _, enc, grid, _, _, _ = small
    ours = enc.color_encoder.signals(grid, plan)
    for a, b in zip(ours, sig):
        assert torch.equal(a, b)


# ---- the attention ----------------------------------------------------------


def _attention_case(w, heads, d, shift, seed):
    """A level whose windows hold a full w^3 block, single points and a
    scatter, with seeded qkv, signals and tables (0.3, so that every term
    weighs)."""
    gen = torch.Generator().manual_seed(seed)
    r = torch.arange(w)
    block = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                        -1).reshape(-1, 3)
    lone = torch.tensor([[10 * w, 0, 0], [0, 10 * w, 0]])
    cells = torch.unique(torch.cat([block, lone, torch.randint(
        w, 4 * w, (200, 3), generator=gen)]), dim=0)
    n = cells.shape[0]
    pos = cells.float() + 0.9 * torch.rand((n, 3), generator=gen)
    col = (2 * torch.rand((n, 3), generator=gen) - 1) / 1.001
    sig = torch.cat([pos, col], 1)
    c = heads * d
    lp, lc = 2 * w * 4, 32
    weights = {"attn.qkv.weight": torch.randn((3 * c, c), generator=gen)
               / c ** 0.5, "attn.qkv.bias": torch.zeros(3 * c),
               "attn.proj.weight": torch.eye(c), "attn.proj.bias":
               torch.zeros(c)}
    for kind in ("query", "key", "value"):
        weights[f"attn.{kind}_xyz_table"] = 0.3 * torch.randn(
            (3, lp, heads, d), generator=gen)
        weights[f"attn.{kind}_rgb_table"] = 0.3 * torch.randn(
            (3, lc, heads, d), generator=gen)
    x = torch.randn((n, c), generator=gen)
    return cells, sig, weights, x


@pytest.mark.parametrize("w,heads,d,shift", [(5, 2, 8, 0), (5, 2, 8, 2),
                                             (7, 2, 16, 0)])
def test_the_plain_attention_is_the_reference_pair_form(w, heads, d, shift):
    """Windows of 1 and of w^3 points (125 / 343, split by the shift when
    it is on): the plain version's per-point dots and value histogram
    against the reference's gathered table rows of every pair."""
    cells, sig, wts, x = _attention_case(w, heads, d, shift, seed=w + shift)
    win = swin_attn.partition(cells, w, shift)
    assert 1 in (win.offsets[1:] - win.offsets[:-1]).tolist()
    attn = S3.WindowAttention(heads * d, heads, w, 4, None)
    attn.load_state_dict({k[5:]: v for k, v in wts.items()})
    s = dict(REF.BASE, window_sizes=[w], channels=[heads * d],
             num_heads=[heads])
    lv = REF.Level(cells, cells.double(), 1)
    net = REF.Net({"l." + k: v for k, v in wts.items()}, [lv], [sig], s)
    with torch.no_grad():
        got = swin_attn.window_attention(attn.qkv(x), win, sig,
                                         attn.tables(), heads)
        want = net.attention("l.attn", x, 0, heads, shift)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_the_kernel_refuses_what_it_does_not_take(small):
    *_, enc, grid, plan, _, _ = small
    lv = plan["levels"][0]
    attn = enc.color_encoder.layers[0].blocks[0].attn
    sig = enc.color_encoder.signals(grid, plan)[0]
    qkv = torch.zeros((lv.n, 48))
    assert swin_attn.check_swin_inputs(qkv, lv.windows[0], sig,
                                       attn.tables(), 2) == 8
    with pytest.raises(ValueError, match="head dim"):
        swin_attn.check_swin_inputs(qkv, lv.windows[0], sig, attn.tables(),
                                    4)
    with pytest.raises(ValueError, match="int32"):
        swin_attn.check_swin_inputs(qkv, lv.windows[0]._replace(
            perm=lv.windows[0].perm.long()), sig, attn.tables(), 2)
    with pytest.raises(ValueError, match=r"\(n, 6\)"):
        swin_attn.check_swin_inputs(qkv, lv.windows[0], sig[:, :3], attn.tables(),
                                    2)


# ---- the model --------------------------------------------------------------


def test_down_up_and_a_block_match_the_reference(small):
    """The kNN downsampling to level 1, a shifted block at level 1 and the
    upsampling back to level 0, each from the same inputs."""
    *_, w, enc, grid, plan, levels, sig = small
    model = enc.color_encoder
    net = REF.Net(w, levels, sig, REF.settings(SMALL))
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((levels[0].n, 16), generator=gen)
    x1 = torch.randn((levels[1].n, 16), generator=gen)
    with torch.no_grad():
        got = model.layers[0].downsample(x0, plan["levels"][1].down_nbr)
        p = "layers.0.downsample."
        want = net.linear(p + "linear", net.layer_norm(p + "norm", x0))[
            levels[1].down].amax(1)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)
        ours = model.signals(grid, plan)
        got = model.layers[1].blocks[1](x1, plan["levels"][1].windows[1],
                                        ours[1])
        want = net.block("layers.1.blocks.1.", x1, 1, 2, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)
        up = model.upsamples[3]  # level 1 -> 0
        got = up(x1, x0, plan["levels"][0])
        z = net.linear("upsamples.3.linear2.1", net.layer_norm(
            "upsamples.3.linear2.0", x1))
        want = net.linear("upsamples.3.linear1.1", net.layer_norm(
            "upsamples.3.linear1.0", x0)) + (
            levels[0].up_w[..., None] * z[levels[0].up]).sum(1)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_backbone_matches_the_reference(small, reference):
    xyz, rgb, w, enc, grid, plan, _, _ = small
    want, net = reference
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
    assert got.shape == (grid.num, 16) and float(want.std()) > 0.1
    assert len(net.launches) == sum(SMALL["depths"]) + 4
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def _backbone_error(small, want, tables=None, partition=None):
    xyz, rgb, w, enc, grid, plan0, _, _ = small
    real_t, real_p = S3.WindowAttention.tables, swin_attn.partition
    if tables is not None:
        S3.WindowAttention.tables = lambda self: tables(real_t(self))
    if partition is not None:
        swin_attn.partition = partition(real_p)
    try:
        with torch.no_grad():
            model = enc.color_encoder
            got = model.backbone(grid, model.build_plan(grid)
                                 if partition else plan0)
    finally:
        S3.WindowAttention.tables, swin_attn.partition = real_t, real_p
    return float((got - want).abs().max())


def _no_colour(t):
    rows = 3 * t.lp
    return t._replace(q=torch.cat([t.q[:rows], 0 * t.q[rows:]]),
                      k=torch.cat([t.k[:rows], 0 * t.k[rows:]]),
                      v=torch.cat([t.v[:rows], 0 * t.v[rows:]]))


@pytest.mark.parametrize("fault", ["colour", "value", "shift"])
def test_a_planted_fault_fails_the_comparison(small, reference, fault):
    """The colour terms of cRSE dropped, the value table dropped, or the
    shift never applied: each moves the backbone by > 10x the tolerance."""
    want = reference[0]
    if fault == "colour":
        err = _backbone_error(small, want, tables=_no_colour)
    elif fault == "value":
        err = _backbone_error(small, want, tables=lambda t: t._replace(
            v=0 * t.v))
    else:
        err = _backbone_error(small, want, partition=lambda real: (
            lambda cells, w, shift: real(cells, w, 0)))
    assert err > 10 * TOL, err


def test_config_and_state_dict_keys():
    info = PCMLInfo.from_dict(INFO)
    assert info.swin3d == S3.Swin3DConfig(**{
        k: tuple(v) for k, v in SMALL.items()})
    assert info.ptv2 is None and info.ptv3 is None
    assert PCMLInfo(model_type="swin3d", clr_encoder_channels="9").swin3d == (
        S3.Swin3DConfig())
    with pytest.raises(NotImplementedError, match="XYZ_RGB"):
        S3.Swin3DConfig(cRSE="XYZ_RGB_NORM")
    model = S3.Swin3DUNet(S3.Swin3DConfig(), 13,
                          torch.Generator().manual_seed(0))
    specs = REF.param_specs(REF.settings({}), 13)
    state = model.state_dict()
    assert [n for n, *_ in specs] == list(state)
    assert all(tuple(state[n].shape) == shape for n, shape, *_ in specs)
    # Swin3D-S: 27 windowed blocks a pass (23 encoder, 4 decoder)
    blocks = sum(len(layer.blocks) for layer in model.layers) + sum(
        len(up.block.blocks) for up in model.upsamples)
    assert blocks == 27
    assert model.cfg.strides() == [1, 3, 6, 12, 24]
    params = dict(model.named_parameters())
    assert sum(p.numel() for p in params.values()) == PARAMETERS
    assert sum(p.numel() for n, p in params.items() if "table" in n) == (
        TABLE_PARAMETERS)


# ---- on the renderer's path -------------------------------------------------


def _cell_config():
    return {"pcml_info": INFO, "cloud": CLOUD, "background": 0.0,
            "raster": {"dup_cap": 256, "chunk": 256, "k_budget": None,
                       "max_active": None, "opacity_radius": True}}


def test_render_matches_the_reference_raster():
    """One ``PCMLRender(model_type "swin3d")`` request of 2 views through
    the benchmark's system module, every view against the reference's
    splats rasterized by the reference, as the cell checks it."""
    from cellbench import harness, scene, systems

    cfg = _cell_config()
    traffic = {"views": 2, "width": 32, "height": 32, "supersample": 2,
               "fov_deg": 45.0, "ring_radius": 3.0}
    system = systems.load("swin3d")
    inputs = system.make_inputs(cfg, SEED, "cpu")
    prog = system.Program(cfg, traffic, inputs, "cpu")
    poses = scene.Cameras(traffic, SEED, "cpu").request(0)
    timing = {}
    with harness.quiet():
        out = prog(poses, timing)
    assert len(timing["swin_attn_work"]) == 2 * (sum(SMALL["depths"]) + 4)
    with torch.no_grad():
        ref = system.reference_splats(cfg, inputs)
        worst, _ = harness.check({"traffic": traffic, "config": cfg},
                                 [(0, poses, out)], ref, system, "cpu")
    assert worst["views_missing"] == 0
    assert worst["image_mae"] <= 5e-5 and worst["hit_mae"] <= 1e-5, worst
    assert float(out["hitmap"].amax()) > 0


def test_render_spans_and_counters(reference):
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
    for child in ("", ".stem", ".attn", ".mlp", ".down", ".up", ".head"):
        assert "gpcr.encode.swin3d" + child in names
    assert {"gpcr.encode.plan.knn", "gpcr.encode.plan.window"} <= names
    assert "gpcr.encode.unet" not in names
    first, second = rec.counters[0], rec.counters[1]
    assert first["plan_builds"] == 1 and second["plan_hits"] == 2
    assert first["knn_queries"] > 0 and "knn_queries" not in second
    assert first["swin_windows"] > 0 and "swin_windows" not in second
    assert 1 <= first["swin_window_max"] <= 343
    pairs = sum(pr * h for _, _, pr, h, _, _ in reference[1].launches)
    launches = sum(SMALL["depths"]) + 4
    for c in (first, second):  # two encodes per request
        assert c["swin_attn_launches"] == 2 * launches
        assert c["swin_attn_pairs"] == 2 * pairs

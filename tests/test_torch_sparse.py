"""Port parity: the sparse voxel engine, the U-Net encoder and checkpoint
loading of ``gpcr_tpu_torch`` against ``gpcr_tpu`` on a ~400-point cloud.

The JAX levels are capacity-padded (SENTINEL codes, miss index ==
capacity); the port's levels hold exactly ``num`` voxels (miss index ==
num). Comparisons run on the valid rows with the miss index mapped.

Tolerances: coordinates, slots and kernel maps equal; averaged features
at rtol/atol 1e-6 (duplicate sums may run in another order); conv outputs
and the whole PCEncoder at atol 1e-4 (27-offset f32 matmul accumulation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.models.encoder import PCEncoder as JPCEncoder
from gpcr_tpu.ops import sparse as JSP
from gpcr_tpu.render import checkpoint as JCK
from gpcr_tpu.render import renderer as JRD
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                           assemble_input_features)
from gpcr_tpu_torch.ops import sparse as TSP
from gpcr_tpu_torch.render import checkpoint as TCK
from gpcr_tpu_torch.render.renderer import pin_fp32

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card

INFO = {
    "clr_encoder_channels": "9 8 8 8 8 8",
    "sh_deg": 1, "sh_feat_deg": 0,
    "use_rotation": True, "use_scale": True, "use_offset": True,
    "use_dc_offset": False, "use_opacity": False, "est_normal": True,
    "normalize_normal": True, "enable_opacity": True,
    "scale_factor": 32, "model_type": "unet",
}


def sphere_cloud(n=400, seed=0, grid=64, jitter=0.0):
    """Points on a sphere in PCGC grid units (offset 512)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = v * 0.8 * (grid // 2) + 512 + rng.randn(n, 3) * jitter
    rgb = (v * 0.5 + 0.5).astype(np.float32)
    return xyz.astype(np.float32), rgb


def _jgrid(coords, feats, valid=None):
    return JSP.quantize_average(
        jnp.asarray(coords), jnp.asarray(feats),
        valid=None if valid is None else jnp.asarray(valid))


def _tgrid(coords, feats, valid=None):
    return TSP.quantize_average(
        torch.from_numpy(coords), torch.from_numpy(feats),
        valid=None if valid is None else torch.from_numpy(valid))


def _kmap_np(jkmap, num):
    """JAX kernel map rows [:num] with its miss index (capacity) -> num."""
    k = np.asarray(jkmap)[:num]
    return np.where(k >= num, num, k)


def test_pack_and_offsets_match_jax():
    c = np.random.RandomState(0).randint(0, 1024, size=(500, 3))
    codes = TSP.pack_coords(torch.from_numpy(c))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(JSP.pack_coords(jnp.asarray(c))))
    np.testing.assert_array_equal(TSP.unpack_coords(codes).numpy(), c)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(TSP._offsets_cube(k).numpy(),
                                      np.asarray(JSP._offsets_cube(k)))


def test_quantize_downsample_kmap_match_jax():
    xyz, rgb = sphere_cloud(jitter=0.7)  # jitter -> duplicate voxels
    valid = np.random.RandomState(1).rand(len(xyz)) > 0.1
    feats = np.concatenate([xyz / 100.0, rgb], -1).astype(np.float32)
    jg = _jgrid(xyz, feats, valid)
    tg = _tgrid(xyz, feats, valid)
    num = int(jg.num)
    assert tg.num == num < int(valid.sum())  # duplicates were merged
    np.testing.assert_array_equal(tg.codes.numpy(), np.asarray(jg.codes)[:num])
    np.testing.assert_allclose(tg.feats.numpy(), np.asarray(jg.feats)[:num],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_kmap_np(JSP.build_kernel_map(jg, 3), num),
                                  TSP.build_kernel_map(tg, 3).numpy())

    jp, jslot, joct = JSP.downsample_coords(jg)
    tp, tslot, toct = TSP.downsample_coords(tg)
    pnum = int(jp.num)
    assert tp.num == pnum and tp.stride == jp.stride == 2
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes)[:pnum])
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot)[:num])
    np.testing.assert_array_equal(toct.numpy(), np.asarray(joct)[:num])
    np.testing.assert_array_equal(_kmap_np(JSP.build_kernel_map(jp, 3), pnum),
                                  TSP.build_kernel_map(tp, 3).numpy())


@pytest.mark.parametrize("op", ["conv", "conv_multi", "conv_down", "conv_up"])
def test_sparse_convs_match_jax(op):
    xyz, rgb = sphere_cloud(seed=2)
    rng = np.random.RandomState(3)
    feats = rng.randn(len(xyz), 6).astype(np.float32)
    jg, tg = _jgrid(xyz, feats), _tgrid(xyz, feats)
    num = tg.num
    w27 = (rng.randn(27, 6, 5) * 0.3).astype(np.float32)
    w8 = (rng.randn(8, 6, 5) * 0.3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    T = torch.from_numpy
    if op in ("conv", "conv_multi"):
        jk = JSP.build_kernel_map(jg, 3)
        tk = TSP.build_kernel_map(tg, 3)
        if op == "conv":
            ref = [JSP.conv(jg, jk, jnp.asarray(w27), jnp.asarray(b), block=None)]
            got = [TSP.conv(tg, tk, T(w27), T(b))]
        else:
            f2 = rng.randn(len(xyz), 3).astype(np.float32)
            w2 = (rng.randn(27, 3, 4) * 0.3).astype(np.float32)
            jf2 = _jgrid(xyz, f2).feats
            tf2 = _tgrid(xyz, f2).feats
            ref = JSP.conv_multi(jg, jk, [jg.feats, jf2],
                                 [jnp.asarray(w27), jnp.asarray(w2)],
                                 [jnp.asarray(b), None], block=None)
            got = TSP.conv_multi(tg, tk, [tg.feats, tf2], [T(w27), T(w2)],
                                 [T(b), None])
        rows = num
    elif op == "conv_down":
        jp, jslot, joct = JSP.downsample_coords(jg)
        tp, tslot, toct = TSP.downsample_coords(tg)
        ref = [JSP.conv_down(jg, jp, jslot, joct, jnp.asarray(w8), jnp.asarray(b))]
        got = [TSP.conv_down(tg, tp, tslot, toct, T(w8), T(b))]
        rows = tp.num
    else:
        jp, _, _ = JSP.downsample_coords(jg)
        tp, _, _ = TSP.downsample_coords(tg)
        cf = rng.randn(jp.capacity, 6).astype(np.float32)
        jc = jp.replace(feats=jnp.asarray(cf))
        tc = tp.replace(feats=T(cf[:tp.num]))
        ref = [JSP.conv_up_generative(jc, jg.codes, jg.num, 1, jnp.asarray(w8),
                                      jnp.asarray(b))]
        got = [TSP.conv_up_generative(tc, tg.codes, T(w8), T(b))]
        rows = num
    for g, r in zip(got, ref):
        assert g.shape[0] == rows
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:rows], atol=1e-4)


def _maps_cloud(seed=5):
    """A dense small cloud (a solid ball, so rows hit many offsets) with
    its plan's ConvMaps built on the CPU."""
    xyz, rgb = sphere_cloud(n=3000, seed=seed, grid=24, jitter=2.0)
    g = _tgrid(xyz, np.concatenate([xyz / 100.0, rgb], -1).astype(np.float32))
    return g, TSP.downsample_coords(g)


def _row_masks(nbr):
    bits = torch.arange(nbr.shape[1])
    return ((nbr >= 0).long() << bits).sum(1)


@pytest.mark.parametrize("kind", ["cube", "down", "up"])
def test_tile_map_orders_rows_and_covers_every_pair(kind):
    """The TiledMap of each map kind against its code-order neighbours:
    rows sorted (stably) by their hit mask, each sorted row's neighbours,
    tile masks that are exactly the OR of their rows' masks, and the
    host's pairs / slots."""
    g, (pg, slot, octant) = _maps_cloud()
    cmap = {"cube": TSP.ConvMap("cube", g, g,
                                kmap=TSP.build_kernel_map(g, 3)),
            "down": TSP.ConvMap("down", g, pg, parent_slot=slot,
                                octant=octant),
            "up": TSP.ConvMap("up", pg, g, parent_slot=slot,
                              octant=octant)}[kind]
    nbr = cmap.neighbours()
    n, k = nbr.shape
    tiles = TSP.tile_map(nbr)
    R = TSP.TILE_ROWS
    n_pad = tiles.rows.shape[0]
    assert n_pad == -(-n // R) * R > n  # the last tile is padded
    order = tiles.rows[:n].long()
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    assert bool((tiles.rows[n:] == -1).all())
    masks = _row_masks(nbr)[order]
    assert bool((masks[1:] >= masks[:-1]).all())
    same = masks[1:] == masks[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())  # stable
    assert tiles.nbr.shape == (k, n_pad) and tiles.nbr.dtype == torch.int32
    assert torch.equal(tiles.nbr[:, :n].T.long(), nbr[order])
    assert bool((tiles.nbr[:, n:] == -1).all())
    hit = tiles.nbr.T.reshape(-1, R, k) >= 0
    want = (hit.any(1).long() << torch.arange(k)).sum(1)
    assert torch.equal(tiles.tile_masks.long(), want)
    # every pair lies in an offset of its tile's mask
    covered = (tiles.tile_masks.long()[:, None] >> torch.arange(k)) & 1
    assert bool((covered[:, None, :].expand_as(hit)[hit] == 1).all())
    assert tiles.pairs == int((nbr >= 0).sum())
    assert tiles.slots == int(covered.sum()) * R
    assert tiles.pairs <= tiles.slots <= n_pad * k
    if kind == "cube":
        kmap = TSP.build_kernel_map(g, 3)
        assert torch.equal(nbr, torch.where(kmap < g.num, kmap, -1))
        # sorted by mask, fewer slots than every offset of every tile
        assert tiles.slots < n_pad * k


def test_child_and_parent_maps_match_downsample_coords():
    """The down map holds each parent's child in its octant's column, the
    up map each fine row's parent (the parent ``lookup`` finds) in its
    octant's column, -1 elsewhere."""
    g, (pg, slot, octant) = _maps_cloud()
    child = TSP.ConvMap("down", g, pg, parent_slot=slot,
                        octant=octant).neighbours()
    assert child.shape == (pg.num, 8)
    fine = torch.arange(g.num)
    assert torch.equal(child[slot, octant], fine)
    assert int((child >= 0).sum()) == g.num
    assert bool((child >= 0).any(1).all())  # every parent has a child
    hit = child >= 0
    kids = child[hit]
    np.testing.assert_array_equal(  # a child sits in its own octant
        TSP._octant(g.coords()[kids]).numpy(),
        torch.arange(8).expand(pg.num, 8)[hit].numpy())
    np.testing.assert_array_equal(
        (g.coords()[kids] >> 1).numpy(),
        pg.coords()[torch.arange(pg.num)[:, None].expand(-1, 8)[hit]].numpy())

    parent = TSP.ConvMap("up", pg, g, parent_slot=slot,
                         octant=octant).neighbours()
    assert parent.shape == (g.num, 8)
    assert int((parent >= 0).sum()) == g.num
    pidx, found = TSP.lookup(pg.codes, TSP.pack_coords(g.coords() >> 1))
    assert bool(found.all())
    assert torch.equal(parent[fine, octant], pidx)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["cube", "down", "up"])
def test_map_driven_sum_matches_the_ops(kind, relu):
    """``conv_map_plain`` over the TiledMap equals ``conv`` / ``conv_down``
    / ``conv_up_generative`` (atol 1e-5: the same float32 products summed
    in another order), and ``conv_map`` on CPU tensors is those ops."""
    g, (pg, slot, octant) = _maps_cloud(seed=6)
    rng = np.random.RandomState(7)
    kv = 27 if kind == "cube" else 8
    src, dst = {"cube": (g, g), "down": (g, pg), "up": (pg, g)}[kind]
    feats = torch.from_numpy(rng.randn(src.num, 6).astype(np.float32))
    w = torch.from_numpy((rng.randn(kv, 6, 5) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    if kind == "cube":
        cmap = TSP.ConvMap("cube", g, g, kmap=TSP.build_kernel_map(g, 3))
        ref = TSP.conv(g.replace(feats=feats), cmap.kmap, w, b)
    elif kind == "down":
        cmap = TSP.ConvMap("down", g, pg, parent_slot=slot, octant=octant)
        ref = TSP.conv_down(g.replace(feats=feats), pg, slot, octant, w, b)
    else:
        cmap = TSP.ConvMap("up", pg, g, parent_slot=slot, octant=octant)
        ref = TSP.conv_up_generative(pg.replace(feats=feats), g.codes, w, b)
    if relu:
        ref = torch.relu(ref)
    got = TSP.conv_map_plain(cmap.tiled_map(), feats, w, b, dst.num,
                             relu=relu)
    assert got.shape == (dst.num, 5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    before = TSP.LAUNCHES
    (ops,) = TSP.conv_map(cmap, [feats], [w], [b], relu=relu)
    assert TSP.LAUNCHES == before  # the CPU never reaches the kernel
    assert torch.equal(ops, ref)


def test_check_conv_inputs_raises_on_what_the_kernel_does_not_take():
    g, _ = _maps_cloud()
    cube = TSP.ConvMap("cube", g, g, kmap=TSP.build_kernel_map(g, 3))
    feats = torch.zeros((g.num, 4))
    w = torch.zeros((27, 4, 3))
    assert cube.tiles is None
    TSP.check_conv_inputs(cube, feats, w, torch.zeros(3))  # accepted
    assert cube.tiles is not None  # built at the first check, and kept
    tiles = cube.tiles
    TSP.check_conv_inputs(cube, feats, w, None)
    assert cube.tiled_map() is tiles
    with pytest.raises(TypeError):
        TSP.check_conv_inputs(cube, feats.double(), w, None)
    with pytest.raises(ValueError, match="contiguous"):
        TSP.check_conv_inputs(cube, torch.zeros((4, g.num)).T, w, None)
    with pytest.raises(ValueError, match="feats shape"):
        TSP.check_conv_inputs(cube, feats[:-1], w, None)
    with pytest.raises(ValueError, match="weight shape"):
        TSP.check_conv_inputs(cube, feats, w[:8], None)
    with pytest.raises(ValueError, match="bias"):
        TSP.check_conv_inputs(cube, feats, w, torch.zeros(4))


def test_plan_maps_and_conv_map_on_the_cpu():
    """A plan carries the ConvMaps of every conv and builds no kernel
    maps; the U-Net's forward on the CPU is the differentiable ops' and
    builds none either."""
    xyz, rgb = sphere_cloud(n=400, seed=8, grid=64)
    info = PCMLInfo.from_dict(INFO)
    coords = torch.from_numpy(np.round(xyz))
    grid = TSP.quantize_average(coords, assemble_input_features(
        info, coords, torch.from_numpy(rgb), 512))
    model = PCEncoder(info)
    plan = model.build_plan(grid)
    maps = plan["maps"]
    assert [len(maps[k]) for k in ("cube", "down", "up")] == [4, 3, 3]
    assert all(m.tiles is None for ms in maps.values() for m in ms)
    for lvl in range(3):
        assert maps["down"][lvl].src is plan["grids"][lvl]
        assert maps["down"][lvl].dst is plan["grids"][lvl + 1]
        assert maps["up"][lvl].src is plan["grids"][lvl + 1]
        assert maps["up"][lvl].dst is plan["grids"][lvl]
    for lvl, cube in enumerate(maps["cube"]):
        assert cube.src is cube.dst is plan["grids"][lvl]
        assert torch.equal(cube.kmap,
                           TSP.build_kernel_map(plan["grids"][lvl], 3))
    before = TSP.LAUNCHES
    with torch.no_grad():
        out = model.color_encoder(grid, plan)
    assert TSP.LAUNCHES == before
    assert all(m.tiles is None for ms in maps.values() for m in ms)
    assert out.shape == (grid.num, info.feat_dim)
    assert bool(torch.isfinite(out).all())


def test_pcencoder_and_brick_kmaps_match_jax():
    """The whole PCEncoder with JAX params carried over by
    load_jax_params, and the port's L0/L1 kernel maps vs the brick-derived
    maps gpcr_tpu's PCMLRender builds (renderer.py:655-665)."""
    xyz, rgb = sphere_cloud(n=400, seed=4, grid=64)
    xyz = np.round(xyz)
    jr = JRD.PCMLRender(info=INFO, voxelized=True, scale_factor=32)
    sp_j, grid_j, plan_j = jr.encode(JPointCloud.from_numpy(xyz, rgb))

    model = PCEncoder(PCMLInfo.from_dict(INFO))
    TCK.load_jax_params(model, jax.tree_util.tree_map(np.asarray, jr.params))
    coords = torch.from_numpy(xyz)
    feats = assemble_input_features(PCMLInfo.from_dict(INFO), coords,
                                    torch.from_numpy(rgb), 512)
    grid = TSP.quantize_average(coords, feats)
    plan = model.build_plan(grid)
    for lvl in (0, 1):
        g = plan["grids"][lvl]
        np.testing.assert_array_equal(
            g.codes.numpy(), np.asarray(plan_j["grids"][lvl].codes)[:g.num])
        np.testing.assert_array_equal(
            plan["maps"]["cube"][lvl].kmap.numpy(),
            _kmap_np(plan_j["kmaps"][lvl], g.num))

    with torch.no_grad():
        sp = model(grid, plan)
    num = grid.num
    assert num == int(grid_j.num)
    for name in ("primitives", "sh", "rotation", "scale", "opacity", "normal",
                 "offsets", "center_points"):
        np.testing.assert_allclose(
            getattr(sp, name).numpy(), np.asarray(getattr(sp_j, name))[:num],
            atol=1e-4, err_msg=name)


def test_checkpoint_formats_roundtrip(tmp_path):
    """JAX .npz -> port; port .npz -> JAX; reference-style .pth -> port."""
    enc = JPCEncoder(INFO)
    params = jax.tree_util.tree_map(np.asarray, enc.init(jax.random.PRNGKey(1)))
    JCK.save_params(str(tmp_path / "j.npz"), params)
    model = PCEncoder(PCMLInfo.from_dict(INFO))
    TCK.load_jax_params(model, TCK.load_params(str(tmp_path / "j.npz")))
    sd = model.state_dict()
    k = "color_encoder.block0.0.conv0_0.kernel"
    np.testing.assert_array_equal(
        sd[k].numpy(), params["color_encoder"]["block0"]["0"]["conv0_0"]["kernel"])

    TCK.save_params(str(tmp_path / "t.npz"), model)
    back = JCK.load_params(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(
        np.asarray(back["color_encoder"]["conv_3"]["bias"]),
        params["color_encoder"]["conv_3"]["bias"])

    # reference layout: 1³ kernels as (Cin, Cout), a constant quaternion
    ref_sd = {key: v.clone() for key, v in sd.items()}
    k1 = "color_encoder.block1.2.conv1_0.kernel"
    ref_sd[k1] = ref_sd[k1][0]
    ref_sd["default_quaternion"] = torch.tensor([1.0, 0, 0, 0])
    torch.save(ref_sd, str(tmp_path / "ref.pth"))
    model2 = PCEncoder(PCMLInfo.from_dict(INFO),
                       generator=torch.Generator().manual_seed(5))
    TCK.load_jax_params(model2, TCK.load_params(str(tmp_path / "ref.pth")))
    for key, v in model2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[key].numpy(), key)
    with pytest.raises(KeyError):
        TCK.load_jax_params(model2, {"color_encoder": {}})

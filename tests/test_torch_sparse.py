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
            plan["kmaps"][lvl].numpy(), _kmap_np(plan_j["kmaps"][lvl], g.num))

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

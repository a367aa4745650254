"""The rest of the port's structures against ``gpcr_tpu`` on the same
seeded numpy inputs: the surfel z-buffer, sparse trilinear interpolation
and pruning, the rest of ``Camera`` and ``Ray``, ``PointersectRecord``,
``ColorCorrector`` and ``GridRayQuery``.

Tolerances: exact for hit maps, winners' colours, indices, codes and
files (``save_camera_frames`` writes the same bytes); 1e-5 for depths
and projections, and for trilinear weights; 1e-6 for float32
elementwise work.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu import native_bindings as JNB
from gpcr_tpu.ops import sparse as JSP
from gpcr_tpu.structures.camera import Camera as JCamera
from gpcr_tpu.structures.color_corrector import ColorCorrector as JColorCorrector
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu.structures.pointersect_record import PointersectRecord as JRecord
from gpcr_tpu.structures.ray import Ray as JRay
from gpcr_tpu.utils import geometry as JG
from gpcr_tpu.utils import rigid_motion as JRM
from gpcr_tpu_torch import native_bindings as TNB
from gpcr_tpu_torch.ops import sparse as TSP
from gpcr_tpu_torch.structures.camera import Camera
from gpcr_tpu_torch.structures.color_corrector import ColorCorrector
from gpcr_tpu_torch.structures.mesh import load_obj
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.structures.pointersect_record import PointersectRecord
from gpcr_tpu_torch.structures.ray import Ray

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)


def _poses(eyes, wh=40, fov=60.0):
    eyes = np.asarray(eyes, np.float32)
    q = len(eyes)
    H = np.asarray(JRM.get_H_c2w_lookat(jnp.asarray(eyes), jnp.zeros((q, 3)),
                                        jnp.asarray([[0.0, 1.0, 0.0]] * q)))
    f = 0.5 * wh / np.tan(0.5 * fov / 180.0 * np.pi)
    K = np.array([[f, 0, wh / 2], [0, f, wh / 2], [0, 0, 1]], np.float32)
    return H.copy(), np.broadcast_to(K, (q, 3, 3)).copy()


def _camera_pair(eyes, wh=40, b=1):
    H, K = _poses(eyes, wh)
    H = np.broadcast_to(H, (b, *H.shape)).copy()
    K = np.broadcast_to(K, (b, *K.shape)).copy()
    return (JCamera(H_c2w=jnp.asarray(H), intrinsic=jnp.asarray(K),
                    width_px=wh, height_px=wh),
            Camera(H_c2w=torch.from_numpy(H), intrinsic=torch.from_numpy(K),
                   width_px=wh, height_px=wh))


# --------------------------------------------------------------------------
# surfel z-buffer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shading,bg", [("raw", 1.0), ("directional", 0.0),
                                        ("half", np.array([0.2, 0.4, 0.6],
                                                          np.float32))])
def test_rasterize_surfel_matches_jax(shading, bg):
    rng = np.random.RandomState(1)
    v = rng.randn(2, 2500, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    xyz, rgb, nrm = ((v * 0.5).astype(np.float32),
                     (v * 0.5 + 0.5).astype(np.float32), v.astype(np.float32))
    valid = rng.rand(2, 2500, 1) > 0.1
    jc, tc = _camera_pair([[0, 0, -2.0], [1.5, 0.3, -1.0]], wh=40, b=2)
    jp = JPointCloud(xyz_w=jnp.asarray(xyz), rgb=jnp.asarray(rgb),
                     normal_w=jnp.asarray(nrm), valid_mask=jnp.asarray(valid))
    tp = PointCloud(xyz_w=torch.from_numpy(xyz), rgb=torch.from_numpy(rgb),
                    normal_w=torch.from_numpy(nrm), valid_mask=torch.from_numpy(valid))
    want = jp.rasterize_surfel(jc, shading=shading, bg_color=bg, bidx=1)
    got = tp.rasterize_surfel(tc, shading=shading, bg_color=bg, bidx=1)
    assert tuple(got.rgb.shape) == (1, 2, 40, 40, 3)
    hit = np.asarray(want.hit_map)
    np.testing.assert_array_equal(got.hit_map.numpy(), hit)
    assert 0.05 < hit.mean() < 0.9
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5)
    np.testing.assert_array_equal(got.camera.H_c2w.numpy(), np.asarray(want.camera.H_c2w))


def test_rasterize_surfel_tie_takes_the_lowest_index():
    """Four points on one pixel: two at the nearest z (one 5e-7 behind, in
    the 1e-6 window) and one invalid in front of them; the lower valid
    index of the tied pair wins, in both packages."""
    xyz = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0 - 5e-7], [0.0, 0.0, 0.5],
                    [0.0, 0.0, 0.9], [0.3, 0.3, 1.0]], np.float32)
    rgb = np.eye(5, 3, dtype=np.float32) + 0.1
    valid = np.array([[1, 1, 1, 0, 1]], bool)[..., None]
    xyz[2] = [0.0, 0.0, 1.2]  # behind the pair
    jc, tc = _camera_pair([[0, 0, -1.0]], wh=16)
    want = JPointCloud(xyz_w=jnp.asarray(xyz[None]), rgb=jnp.asarray(rgb[None]),
                       valid_mask=jnp.asarray(valid)).rasterize_surfel(jc)
    got = PointCloud(xyz_w=torch.from_numpy(xyz[None]), rgb=torch.from_numpy(rgb[None]),
                     valid_mask=torch.from_numpy(valid)).rasterize_surfel(tc)
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_array_equal(got.hit_map.numpy(), np.asarray(want.hit_map))
    assert int(got.hit_map.sum()) == 2
    centre = got.rgb[0, 0, 8, 8].numpy()
    np.testing.assert_array_equal(centre, rgb[0])


# --------------------------------------------------------------------------
# sparse interpolation and pruning
# --------------------------------------------------------------------------


def _grids(n=120, extent=10, cin=5, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.randint(0, extent, (n, 3)).astype(np.float32)
    feats = rng.randn(n, cin).astype(np.float32)
    jg = JSP.quantize_average(jnp.asarray(coords), jnp.asarray(feats), capacity=n + 9)
    tg = TSP.quantize_average(torch.from_numpy(coords), torch.from_numpy(feats))
    assert tg.num == int(jg.num)
    return jg, tg


def test_interpolate_trilinear_matches_jax():
    jg, tg = _grids()
    pts = np.random.RandomState(2).uniform(-1.5, 11.5, (400, 3)).astype(np.float32)
    pts[:8] = np.floor(pts[:8])  # on voxel centres: one corner of weight 1
    want = np.asarray(JSP.interpolate_trilinear(jg, jnp.asarray(pts)))
    got = TSP.interpolate_trilinear(tg, torch.from_numpy(pts))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(want).sum(1).min() == 0.0  # some points see no voxel


def test_prune_matches_jax():
    jg, tg = _grids(seed=4)
    keep = np.random.RandomState(5).rand(jg.capacity) > 0.4
    jp = JSP.prune(jg, jnp.asarray(keep))
    tp = TSP.prune(tg, torch.from_numpy(keep[:tg.num]))
    num = int(jp.num)
    assert tp.num == num and tp.stride == jp.stride
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes[:num]))
    np.testing.assert_array_equal(tp.feats.numpy(), np.asarray(jp.feats[:num]))
    down, _, _ = TSP.downsample_coords(tp)  # stride 2
    jdown, _, _ = JSP.downsample_coords(jp)
    np.testing.assert_array_equal(down.world_coords().numpy(),
                                  np.asarray(jdown.world_coords())[:down.num])


# --------------------------------------------------------------------------
# Camera and Ray
# --------------------------------------------------------------------------


def _views(q=12, b=2):
    rng = np.random.RandomState(3)
    eyes = rng.randn(q, 3) * 2 + [0, 0, 3]
    return _camera_pair(eyes, wh=32, b=b)


def test_camera_slicing_matches_jax():
    jc, tc = _views()
    assert tc.batch_shape == jc.batch_shape == (2, 12)
    np.testing.assert_array_equal(tc.get_camera_origin_w().numpy(),
                                  np.asarray(jc.get_camera_origin_w()))

    def same(t, j):
        assert (t.width_px, t.height_px) == (j.width_px, j.height_px)
        np.testing.assert_array_equal(t.H_c2w.numpy(), np.asarray(j.H_c2w))
        np.testing.assert_array_equal(t.intrinsic.numpy(), np.asarray(j.intrinsic))

    for dim, index in ((1, [3, 0, 7]), (0, [1]), (1, 5)):
        same(tc.index_select(dim, index), jc.index_select(dim, jnp.asarray(index)))
    for chunks, dim in ((5, 1), (2, 0), (12, 1)):
        t_parts, j_parts = tc.chunk(chunks, dim=dim), jc.chunk(chunks, dim=dim)
        assert [p.H_c2w.shape[dim] for p in t_parts] == [
            p.H_c2w.shape[dim] for p in j_parts]
        for t, j in zip(t_parts, j_parts):
            same(t, j)
        same(Camera.cat(t_parts, dim=dim), jc)
    for max_pixels in (32 * 32 * 5, 10, 10 ** 6):
        t_parts, j_parts = tc.split(max_pixels), jc.split(max_pixels)
        assert len(t_parts) == len(j_parts)
        for t, j in zip(t_parts, j_parts):
            same(t, j)
        same(Camera.cat(t_parts, dim=1), jc)


def test_camera_frames_match_jax_byte_for_byte(tmp_path):
    jc, tc = _views(q=3, b=2)
    for trow, jrow in zip(tc.get_camera_frames(0.2), jc.get_camera_frames(0.2)):
        for t, j in zip(trow, jrow):
            for k in ("vertices", "triangles", "colors"):
                np.testing.assert_array_equal(t[k], j[k])
                assert t[k].dtype == j[k].dtype
    a, b = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    jc.save_camera_frames(a, camera_frame_size=0.2, world_frame_size=1.0)
    tc.save_camera_frames(b, camera_frame_size=0.2, world_frame_size=1.0)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = load_obj(b)
    assert back["vertices"].shape == (7 * 32, 3)
    assert back["triangles"].shape == (7 * 48, 3)


def test_ray_reshape_chunk_cat_match_jax():
    rng = np.random.RandomState(6)
    o = rng.randn(2, 6, 5, 3).astype(np.float32)
    d = rng.randn(2, 6, 5, 3).astype(np.float32)
    jr, tr = JRay(jnp.asarray(o), jnp.asarray(d)), Ray(torch.from_numpy(o), torch.from_numpy(d))
    for t, j in ((tr.reshape(2, 30), jr.reshape(2, 30)),
                 (Ray.cat(tr.chunk(4, dim=1), dim=1), jr)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(t.origins_w.numpy(), np.asarray(j.origins_w))
        np.testing.assert_array_equal(t.directions_w.numpy(), np.asarray(j.directions_w))
    assert [p.shape[1] for p in tr.chunk(4, dim=1)] == [
        p.shape[1] for p in jr.chunk(4, dim=1)] == [2, 2, 1, 1]
    sd_t, sd_j = tr.state_dict(), jr.state_dict()
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], sd_j[k])


# --------------------------------------------------------------------------
# PointersectRecord
# --------------------------------------------------------------------------


def _records(b=1, q=2, h=4, w=5, k=3, seed=0):
    rng = np.random.RandomState(seed)
    m = q * h * w
    nrm = rng.randn(b, m, 3)
    d = {
        "intersection_xyz_w": rng.randn(b, m, 3) + [0, 0, 0.5],
        "intersection_surface_normal_w": nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
        "intersection_rgb": rng.rand(b, m, 3),
        "blending_weights": rng.rand(b, m, k),
        "neighbor_point_idxs": rng.randint(0, 100, (b, m, k)),
        "ray_t": rng.rand(b, m) * 3,
        "ray_hit": (rng.rand(b, m) > 0.3).astype(np.float32),
        "ray_hit_logit": rng.randn(b, m),
        "model_attn_weights": rng.rand(b, m, k),
    }
    d = {key: (v.astype(np.float32) if v.dtype == np.float64 else v)
         for key, v in d.items()}
    return (JRecord(**{key: jnp.asarray(v) for key, v in d.items()}),
            PointersectRecord(**{key: torch.from_numpy(v) for key, v in d.items()}))


def _same_record(t, j, tol=0.0):
    for key in PointersectRecord._ATTRS:
        a, b = getattr(t, key), getattr(j, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)


def test_pointersect_record_matches_jax():
    jr, tr = _records()
    _same_record(tr.reshape(2, 4, 5), jr.reshape(2, 4, 5))
    t_parts, j_parts = tr.chunk(3), jr.chunk(3)
    assert [p.ray_t.shape[1] for p in t_parts] == [p.ray_t.shape[1] for p in j_parts]
    _same_record(PointersectRecord.cat(t_parts), jr)
    jr2, tr2 = _records(seed=1)
    _same_record(PointersectRecord.aggregate([tr, tr2]),
                 JRecord.aggregate([jr, jr2]), tol=1e-6)
    no_logit = dataclasses.replace(tr, ray_hit_logit=None)
    zdir = np.random.RandomState(2).randn(1, 40, 3).astype(np.float32)
    for t, j in ((tr, jr), (no_logit, jr.replace(ray_hit_logit=None))):
        for z in (None, zdir):
            np.testing.assert_allclose(
                t.compute_confidence(None if z is None else torch.from_numpy(z)).numpy(),
                np.asarray(j.compute_confidence(None if z is None else jnp.asarray(z))),
                atol=1e-6)
    sd_t, sd_j = no_logit.state_dict(), jr.replace(ray_hit_logit=None).state_dict()
    assert sorted(sd_t) == sorted(sd_j) and "ray_hit_logit" not in sd_t
    for key in sd_j:
        np.testing.assert_array_equal(sd_t[key], sd_j[key])


@pytest.mark.parametrize("with_hit", [True, False])
def test_pointersect_record_rgbd_matches_jax(with_hit):
    jr, tr = _records()
    if not with_hit:
        xyz = tr.intersection_xyz_w.clone()
        xyz[0, 3] = float("inf")
        tr = dataclasses.replace(tr, ray_hit=None, intersection_xyz_w=xyz)
        jr = jr.replace(ray_hit=None, intersection_xyz_w=jnp.asarray(xyz.numpy()))
    H, K = _poses([[0.3, 0.2, -3.0], [2.0, 0.5, -2.0]], wh=5)
    K[:, 1, 2] = 2.0  # 5 wide, 4 high
    jc = JCamera(H_c2w=jnp.asarray(H[None]), intrinsic=jnp.asarray(K[None]),
                 width_px=5, height_px=4)
    tc = Camera(H_c2w=torch.from_numpy(H[None]), intrinsic=torch.from_numpy(K[None]),
                width_px=5, height_px=4)
    want, got = jr.get_rgbd_image(jc), tr.get_rgbd_image(tc)
    np.testing.assert_array_equal(got.hit_map.numpy(), np.asarray(want.hit_map))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=1e-5)
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_array_equal(got.normal_w.numpy(), np.asarray(want.normal_w))


# --------------------------------------------------------------------------
# ColorCorrector
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["wrgb", "identify"])
def test_color_corrector_matches_jax(kind):
    jcc, tcc = JColorCorrector(kind), ColorCorrector(kind, device="cpu")
    params = jcc.init()
    np.testing.assert_array_equal(tcc.wrgb.detach().numpy(), np.asarray(params["wrgb"]))
    gain = np.array([0.8, 1.1, 1.3], np.float32)
    params = {"wrgb": jnp.asarray(gain)}
    with torch.no_grad():
        tcc.wrgb.copy_(torch.from_numpy(gain))
    x = np.random.RandomState(0).rand(2, 4, 5, 3).astype(np.float32)
    np.testing.assert_allclose(tcc(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jcc.apply(params, jnp.asarray(x))), atol=1e-6)
    if kind == "wrgb":
        opt = torch.optim.Adam(tcc.parameters(), lr=0.01)
        loss = ((tcc(torch.from_numpy(x)) - 0.5) ** 2).mean()
        loss.backward()
        opt.step()
        assert not torch.equal(tcc.wrgb.detach(), torch.from_numpy(gain))
    with pytest.raises(NotImplementedError):
        ColorCorrector("affine", device="cpu")


# --------------------------------------------------------------------------
# GridRayQuery
# --------------------------------------------------------------------------


def test_grid_ray_query_matches_jax_and_brute_force():
    if TNB.get_raytracer() is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.RandomState(0)
    pts = rng.randn(3000, 3).astype(np.float32)
    o = (rng.randn(40, 3) * 2).astype(np.float32)
    d = rng.randn(40, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    radius, k = 0.4, 5
    got = TNB.GridRayQuery(pts, cell_size=radius).query(
        o, d, k=k, t_min=0.0, t_max=100.0, radius=radius)
    want = JNB.GridRayQuery(pts, cell_size=radius).query(
        o, d, k=k, t_min=0.0, t_max=100.0, radius=radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    idx, dist, _ = got
    brute = JG.get_k_neighbor_points(jnp.asarray(pts)[None], jnp.asarray(o)[None],
                                     jnp.asarray(d)[None], k=k, t_min=0.0, t_max=100.0)
    bd = np.asarray(brute["sorted_dists"][0])
    bidx = np.asarray(brute["sorted_idxs"][0])
    inside = bd <= radius - 1e-5
    assert inside.sum() > 20
    np.testing.assert_array_equal(idx[inside], bidx[inside])
    np.testing.assert_allclose(dist[inside], bd[inside], atol=1e-5)
    assert ((idx[~inside] == -1) | (dist[~inside] > radius - 1e-4)).all()

"""Port parity: the multi-GPU paths of ``gpcr_tpu_torch.parallel`` and the
tile window of the stream binning and blend, against ``gpcr_tpu`` on the
CPU.

Tolerances: windowed binning is exact (starts, overflow and the live
stream rows equal); the windows of the plain blend, assembled, give the
unwindowed plain blend's bits; images at 1e-5 against JAX's
``rasterize_tile_sharded`` (tests/test_parallel_render.py's bar) and 2e-5
against JAX's ``render_views_sharded`` (the same file's). JAX runs on the
8-device CPU mesh of tests/conftest.py; the port's collectives run in a
world of one ``gloo`` process made and destroyed by a fixture, and in one
spawned world of 4 CPU processes (``parallel.dryrun``).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import rasterize_stream as JRS
from gpcr_tpu.parallel import render as JPR
from gpcr_tpu.parallel.sharding import make_mesh as j_make_mesh
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.parallel import distributed, dryrun
from gpcr_tpu_torch.parallel import render as TPR
from gpcr_tpu_torch.parallel import sharding
from gpcr_tpu_torch.render import renderer as TRD
from gpcr_tpu_torch.render.renderer import pin_fp32

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank ``gloo`` process group for the test, destroyed after it."""
    assert distributed.initialize(
        init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
        rank=0, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _camera(W, H, eye=(0.0, 0.2, -2.5), fov_deg=60.0):
    """Reference-layout (transposed) view / full-projection matrices."""
    eye = np.asarray(eye, np.float64)
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    view_t = np.linalg.inv(c2w).T.astype(np.float32)
    th = math.tan(math.radians(fov_deg) / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.0 / th
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    return (view_t, (view_t @ P.T).astype(np.float32),
            math.tan(math.radians(fov_deg)), eye.astype(np.float32))


def scene(n, wh, seed, channels=3, spread=0.6, scale=0.08):
    """Seeded gaussians and both packages' settings for a wh² view."""
    rng = np.random.RandomState(seed)
    a = dict(
        means=rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        scales=(rng.uniform(0.3, 1.0, (n, 3)) * scale).astype(np.float32),
        rots=(rng.randn(n, 4) + [2.0, 0, 0, 0]).astype(np.float32),
        op=rng.uniform(0.3, 1.0, n).astype(np.float32),
        feats=rng.rand(n, channels).astype(np.float32))
    view_t, full_t, tanfov, campos = _camera(wh, wh)
    bg = np.linspace(0.1, 0.6, channels).astype(np.float32)
    common = dict(image_height=wh, image_width=wh, tanfovx=tanfov,
                  tanfovy=tanfov, scale_modifier=1.0, sh_degree=0)
    js = JR.GaussianRasterizationSettings(
        bg=jnp.asarray(bg), viewmatrix=jnp.asarray(view_t),
        projmatrix=jnp.asarray(full_t), campos=jnp.asarray(campos), **common)
    ts = TR.GaussianRasterizationSettings(
        bg=torch.from_numpy(bg), viewmatrix=torch.from_numpy(view_t),
        projmatrix=torch.from_numpy(full_t), campos=torch.from_numpy(campos),
        **common)
    return a, js, ts


def _preps(a, js, ts, jcfg, tcfg):
    jp = JR.preprocess(jnp.asarray(a["means"]), jnp.asarray(a["op"]), js, jcfg,
                       scales=jnp.asarray(a["scales"]),
                       rotations=jnp.asarray(a["rots"]),
                       colors_precomp=jnp.asarray(a["feats"]))
    tp = TR.preprocess(torch.from_numpy(a["means"]), torch.from_numpy(a["op"]),
                       ts, tcfg, scales=torch.from_numpy(a["scales"]),
                       rotations=torch.from_numpy(a["rots"]),
                       colors_precomp=torch.from_numpy(a["feats"]))
    return jp, tp


# 16 tiles (64²) and 9 tiles (48², the trailing window runs past the end)
SCENES = {16: (120, 64, 9), 9: (80, 48, 5)}


@pytest.mark.parametrize("window", range(4))
@pytest.mark.parametrize("tiles", [16, 9])
def test_windowed_binning_matches_jax(tiles, window):
    """Each window of a 4-way split bins as gpcr_tpu's
    ``bin_sorted_stream(tile_window=...)``: starts, overflow and the live
    stream rows equal."""
    n, wh, seed = SCENES[tiles]
    a, js, ts = scene(n, wh, seed)
    jcfg, tcfg = (JR.RasterizeConfig(max_dup_per_gaussian=8, chunk_size=32),
                  TR.RasterizeConfig(max_dup_per_gaussian=8, chunk_size=32))
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    grid = wh // 16
    base, count = TPR.window_of(tiles, 4, window)
    stream, starts, ovf = TRS.bin_sorted_stream(tp, tiles, grid, tcfg,
                                                tile_window=(base, count))
    j_stream, j_starts, j_ovf, _ = JRS.bin_sorted_stream(
        jp, tiles, grid, jcfg, tile_window=(base, count))
    j_starts, j_rows = np.array(j_starts), np.asarray(j_stream)
    if base + count > tiles:
        # gpcr_tpu's emit marks its unused (cap, n) slots with tile id
        # num_tiles, which a window past the end of the grid takes for
        # its first tile: inert zero rows (ROADMAP §3); the port keeps
        # only the window's real tiles
        s = tiles - base
        lo, hi = j_starts[s], j_starts[s + 1]
        assert hi > lo and not j_rows[lo:hi].any()
        j_rows = np.concatenate([j_rows[:lo], j_rows[hi:]])
        j_starts[s + 1:] -= hi - lo
    assert starts.shape == (count + 1,)
    np.testing.assert_array_equal(starts.numpy(), j_starts)
    assert int(ovf) == int(j_ovf)
    total = int(starts[-1])
    assert stream.shape[0] == total
    np.testing.assert_array_equal(stream.numpy(),
                                  j_rows[:total, :stream.shape[1]])
    if window < 3:  # the middle of the frame holds entries in every window
        assert total > 0


def test_windowed_per_window_budget_overflow():
    """tests/test_parallel_render.py::test_tile_sharded_per_shard_budget_overflow
    on the port: one window's tiles overflow their LOCAL k_budget while the
    others don't; the tile-sharded overflow is the MAX over the windows
    (each as gpcr_tpu's windowed stream binning counts it), and a budget
    large enough for every window reports zero. The stream binning cuts
    the budget in sorted order with the budget rounded up to a chunk, so
    the chunk is the budget here."""
    W = H = 64  # 4x4 tiles; window i owns 2 of 8
    n = 60
    rng = np.random.RandomState(7)
    means = rng.uniform(-0.55, -0.25, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-0.1, 0.1, n)
    a = dict(means=means, scales=np.full((n, 3), 0.02, np.float32),
             rots=np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
             op=np.full((n,), 0.8, np.float32),
             feats=rng.rand(n, 3).astype(np.float32))
    _, js, ts = scene(1, W, 0)
    view_t, full_t, tanfov, campos = _camera(W, H, eye=(0.0, 0.0, -2.5))
    js = js._replace(viewmatrix=jnp.asarray(view_t),
                     projmatrix=jnp.asarray(full_t),
                     campos=jnp.asarray(campos))
    ts = ts._replace(viewmatrix=torch.from_numpy(view_t),
                     projmatrix=torch.from_numpy(full_t),
                     campos=torch.from_numpy(campos))
    kb = 8
    jcfg = JR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=kb)
    tcfg = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=kb)
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    windows = [TPR.window_of(16, 8, d) for d in range(8)]
    per_window = [int(TRS.bin_sorted_stream(tp, 16, 4, tcfg,
                                            tile_window=w)[1][-1])
                  for w in windows]
    assert max(per_window) > kb and min(per_window) == 0, per_window

    def overflow(k_budget):
        cfg = tcfg._replace(k_budget=k_budget)
        got = [int(TRS.blend_stream(tp, None, 16, 4, cfg, 3, *w)[2])
               for w in windows]
        want = [int(JRS.bin_sorted_stream(
            jp, 16, 4, jcfg._replace(k_budget=k_budget), tile_window=w)[2])
            for w in windows]
        assert got == want
        return max(got)

    assert overflow(kb) == max(per_window) - kb
    assert overflow(4096) == 0


@pytest.mark.parametrize("tiles", [16, 9])
def test_assembled_windows_equal_unwindowed_blend(tiles):
    """The plain blend's windows of a 4-way split, assembled, give the
    unwindowed plain blend's bits, and the composited image is within 1e-5
    of gpcr_tpu's ``rasterize_tile_sharded`` on the 8-device mesh (its
    windowed Pallas stream kernel in interpret mode, jitted). No budget
    binds: with one, windows keep other entries by design."""
    n, wh, seed = SCENES[tiles]
    a, js, ts = scene(n, wh, seed, channels=4)
    kw = dict(max_dup_per_gaussian=16, chunk_size=32, tile_batch=4)
    # JAX's kernel steps over 2 tiles (its 8 windows hold 2 tiles each)
    jcfg = JR.RasterizeConfig(impl="stream", tiles_per_step=2, **kw)
    tcfg = TR.RasterizeConfig(**kw)
    _, tp = _preps(a, js, ts, jcfg, tcfg)
    grid = wh // 16
    acc, t_run, ovf = TRS.blend_stream(tp, None, tiles, grid, tcfg, 4)
    parts = [TRS.blend_stream(tp, None, tiles, grid, tcfg, 4,
                              *TPR.window_of(tiles, 4, d)) for d in range(4)]
    acc_w = torch.cat([p[0] for p in parts])[:tiles]
    t_w = torch.cat([p[1] for p in parts])[:tiles]
    assert torch.equal(acc_w, acc) and torch.equal(t_w, t_run)
    assert max(int(p[2]) for p in parts) == int(ovf) == 0
    out = acc_w + t_w[..., None] * ts.bg[None, None, :]
    # with the background, the windows carry it the same way
    out_s = torch.cat([TRS.blend_stream(tp, ts.bg, tiles, grid, tcfg, 4,
                                        *TPR.window_of(tiles, 4, d))[0]
                       for d in range(4)])[:tiles]
    assert torch.equal(out_s, out)
    color, t_img = TR.assemble_tiles(out, t_w, wh, wh, tcfg)

    mesh = j_make_mesh(sp=8)
    run = jax.jit(lambda m, o, s, r, f: JPR.rasterize_tile_sharded(
        m, o, js, mesh, scales=s, rotations=r, colors_precomp=f,
        config=jcfg))
    with mesh:
        j_color, _, j_t, j_ovf = run(
            *(jnp.asarray(a[k]) for k in ("means", "op", "scales", "rots",
                                          "feats")))
    assert int(j_ovf) == 0
    np.testing.assert_allclose(color.numpy(), np.asarray(j_color), atol=1e-5)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_t), atol=1e-5)


def _fused_inputs(q=3, wh=64, n=80, seed=5, sh_deg=1):
    """tests/test_parallel_render.py's render_views_fused inputs (q views
    of a seeded scene), as numpy."""
    rng = np.random.RandomState(seed)
    a, _, _ = scene(n, wh, seed)
    cams = [_camera(wh, wh, eye=(0.5 * np.sin(0.3 * i), 0.2, -2.5 + 0.2 * i))
            for i in range(q)]
    return [np.stack([c[0] for c in cams]), np.stack([c[1] for c in cams]),
            np.stack([c[3] for c in cams]), a["means"], a["scales"],
            a["rots"], a["op"],
            rng.rand(n, (2 ** (sh_deg + 1)) * 3 + 1, 3).astype(np.float32),
            rng.randn(n, 3).astype(np.float32), np.ones(n, bool),
            np.array([0.2, 0.3, 0.1], np.float32)], cams[0][2]


@pytest.mark.parametrize("mode", ["views", "tiles"])
def test_render_views_sharded_matches_jax(world_of_one, mode):
    """``render_views_sharded`` (3 views, 64² at x2) in a world of one rank
    against JAX's on the 8-device mesh (views padded to 8 there)."""
    arrays, tanfov = _fused_inputs()
    kw = dict(height=64, width=64, out_h=32, out_w=32, sh_degree=1,
              with_normal=True)
    ckw = dict(max_dup_per_gaussian=32, chunk_size=32, tile_batch=4)
    jmesh = j_make_mesh(sp=8)
    run = jax.jit(functools.partial(
        JPR.render_views_sharded, jmesh, mode,
        config=JR.RasterizeConfig(**ckw), **kw))
    with jmesh:
        ref = run(*(jnp.asarray(x) for x in arrays), jnp.float32(tanfov))
    mesh = sharding.make_mesh(sp=1)
    assert mesh.world is not None and mesh.shape == {"dp": 1, "sp": 1}
    got = TRD.render_views_sharded(
        mesh, mode, *(torch.from_numpy(x) for x in arrays), tanfov,
        config=TR.RasterizeConfig(**ckw), **kw)
    for k in ("rgb", "xyz_w", "hitmap", "normal"):
        assert got[k].shape == (3, 32, 32, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, err_msg=f"{mode}/{k}")
    np.testing.assert_array_equal(got["dup_overflow"].numpy(),
                                  np.asarray(ref["dup_overflow"]))


def test_shard_batch_and_single_process_rules(monkeypatch):
    """An unknown batch key raises and names the key (a declared one is
    split); one process without a launcher starts no group, owns the
    whole batch and lays out a 1 x 1 mesh; a mesh that does not cover the
    world raises."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.local_batch_slice(10) == slice(0, 10)
    mesh = sharding.make_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.world is None
    batch = {"coords": torch.zeros(2, 8, 3), "mystery": torch.zeros(2, 4),
             "tanfov": torch.tensor(1.0)}
    with pytest.raises(ValueError, match="mystery"):
        sharding.shard_batch(batch, mesh)
    out = sharding.shard_batch(batch, mesh, spec={"mystery": "view"})
    assert set(out) == {"coords", "mystery", "tanfov"}
    assert all(out[k] is batch[k] or torch.equal(out[k], batch[k])
               for k in out)
    with pytest.raises(ValueError, match="world"):
        sharding.make_mesh(sp=2)
    with pytest.raises(ValueError, match="world"):
        sharding.make_mesh(n_devices=4)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_four_gloo_ranks(n):
    """One spawned world of n CPU processes: a dp x sp training step
    against one process on the whole batch (1e-5), views (3 over the
    ranks, padded) and tiles against render_views_fused (2e-5), replicate,
    and the tile-sharded overflow as the MAX of the windows' (4 windows
    that overflow differently; one window, the whole grid, for the
    one-rank world that ``python -m gpcr_tpu_torch.entry`` starts on one
    card). By default it asks for one card per rank and refuses to start
    without them."""
    if torch.cuda.device_count() < n:
        with pytest.raises(RuntimeError, match=f"needs {n} cards"):
            dryrun.dryrun_multichip(n)
    dryrun.dryrun_multichip(n, timeout=300, device="cpu")


@pytest.mark.parametrize("shard", ["views", "tiles"])
def test_pcml_render_sharded_matches_unsharded(world_of_one, shard):
    """``PCMLRender(shard=...)`` (the CLI's ``pcrender --shard``) in a
    world of one rank against the unsharded renderer: 'views' the same
    images bit for bit, 'tiles' (rendered at full size, halved after)
    within 1e-5."""
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    rng = np.random.RandomState(0)
    v = rng.randn(400, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pcd = PointCloud.from_numpy(np.round(v * 0.8 * 64 + 512).astype(np.float32),
                                (v * 0.5 + 0.5).astype(np.float32))
    info = {"clr_encoder_channels": "9 8 8 8 8 8", "scale_factor": 64}
    cam = TRD.generate_cam({"fov": 60, "width_px": 32, "height_px": 32,
                            "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                            "center_angles": [90, 0]})
    outs = [TRD.PCMLRender(info=info, voxelized=True, device="cpu",
                           shard=s).render(pcd, None, cam, 60.0,
                                           background_color=1.0)
            for s in (None, shard)]
    for k in ("rgb", "xyz_w", "hitmap", "normal"):
        if shard == "views":
            assert torch.equal(outs[1][k], outs[0][k]), k
        else:
            np.testing.assert_allclose(outs[1][k].numpy(),
                                       outs[0][k].numpy(), atol=1e-5,
                                       err_msg=k)

"""Port parity: binning, the stream blend and the rasterizer entry points
of ``gpcr_tpu_torch`` against ``gpcr_tpu``'s stream path (the Pallas
kernel in interpret mode, as tests/test_stream.py runs it) and its exact
XLA path.

Tolerances: binning is exact (starts, overflow, sorted ranks equal; the
gathered stream columns bit-equal); blended images at atol 1e-5, the
tests/test_stream.py bar (the channel sums run in another order).

The CUDA kernel itself is checked against the plain version on the card
by tests/test_torch_gpu.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import rasterize_stream as JRS
from gpcr_tpu_torch.ops import cuda_build
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.render.renderer import pin_fp32

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card


def scene(n=400, seed=0, channels=12, H=64, W=64):
    """tests/test_stream.py's scene, as numpy, plus both settings."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.3 + np.array([0, 0, 2.5])).astype(np.float32)
    scales = (rng.rand(n, 3) * 0.05 + 0.01).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    op = rng.rand(n).astype(np.float32)
    feats = rng.rand(n, channels).astype(np.float32)
    valid = rng.rand(n) > 0.1
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.0
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    bg = np.full((channels,), 0.7, np.float32)
    js = JR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=1.0, tanfovy=1.0,
        bg=jnp.asarray(bg), scale_modifier=1.0, viewmatrix=jnp.eye(4),
        projmatrix=jnp.asarray(P.T), sh_degree=0, campos=jnp.zeros(3))
    ts = TR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=1.0, tanfovy=1.0,
        bg=torch.from_numpy(bg), scale_modifier=1.0, viewmatrix=torch.eye(4),
        projmatrix=torch.from_numpy(P.T.copy()), sh_degree=0,
        campos=torch.zeros(3))
    arrays = dict(means=means, scales=scales, rots=rots, op=op, feats=feats,
                  valid=valid)
    return arrays, js, ts


def _jax_args(a):
    return dict(scales=jnp.asarray(a["scales"]), rotations=jnp.asarray(a["rots"]),
                colors_precomp=jnp.asarray(a["feats"]),
                valid_mask=jnp.asarray(a["valid"]))


def _torch_args(a):
    return dict(scales=torch.from_numpy(a["scales"]),
                rotations=torch.from_numpy(a["rots"]),
                colors_precomp=torch.from_numpy(a["feats"]),
                valid_mask=torch.from_numpy(a["valid"]))


def _configs(**kw):
    return JR.RasterizeConfig(**kw), TR.RasterizeConfig(**kw)


def _preps(a, js, ts, jcfg, tcfg):
    jp = JR.preprocess(jnp.asarray(a["means"]), jnp.asarray(a["op"]), js, jcfg,
                       **_jax_args(a))
    tp = TR.preprocess(torch.from_numpy(a["means"]), torch.from_numpy(a["op"]),
                       ts, tcfg, **_torch_args(a))
    return jp, tp


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------


@pytest.mark.parametrize("opacity_radius", [False, True])
def test_binning_matches_jax_exactly(opacity_radius):
    a, js, ts = scene(seed=1)
    a["scales"][:, 0] *= 3.0  # anisotropic: multi-tile rects and dup-cap hits
    jcfg, tcfg = _configs(max_dup_per_gaussian=8, chunk_size=64,
                          opacity_radius=opacity_radius)
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    stream, starts, ovf, ranks, gidx_s = TRS.bin_sorted_stream(
        tp, 16, 4, tcfg, return_entries=True)
    j_stream, j_starts, j_ovf, _, j_g, j_gidx = JRS.bin_sorted_stream(
        jp, 16, 4, jcfg, return_entries=True)
    total = int(starts[-1])
    assert total == int(JR.entry_count(jp, jcfg)) > 0
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    assert int(ovf) == int(j_ovf) > 0
    np.testing.assert_array_equal(gidx_s.numpy(), np.asarray(j_gidx))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(j_g)[:total])
    # [x, y, conic(3), op, depth, 0, feat(C)] bit-equal
    np.testing.assert_array_equal(
        stream.numpy(), np.asarray(j_stream)[:total, :stream.shape[1]])


def test_cpu_binning_takes_the_plain_version():
    """CPU tensors run ``bin_sorted_stream_plain``, never the kernels."""
    a, js, ts = scene(seed=2)
    _, tcfg = _configs(max_dup_per_gaussian=8, chunk_size=64)
    tp = TR.preprocess(torch.from_numpy(a["means"]), torch.from_numpy(a["op"]),
                       ts, tcfg, **_torch_args(a))
    before = TRS.LAUNCHES_BIN
    got = TRS.bin_sorted_stream(tp, 16, 4, tcfg, return_entries=True,
                                tile_window=(4, 8))
    ref = TRS.bin_sorted_stream_plain(tp, 16, 4, tcfg, return_entries=True,
                                      tile_window=(4, 8))
    assert TRS.LAUNCHES_BIN == before
    assert got[0].shape[0] > 0 and got[1].shape == (9,)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# --------------------------------------------------------------------------
# blend: plain version vs blend_stream(interpret=True)
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "downscale,max_active_tiles,k_budget",
    [(1, None, None), (2, None, None), (1, 8, None), (2, 16, None),
     (1, None, 1024)],
)
def test_blend_matches_pallas_interpret(monkeypatch, downscale,
                                        max_active_tiles, k_budget):
    """max_active_tiles 8 cuts tiles (a multiple of the JAX kernel's 4
    tiles per grid step, which its unpermute needs); 16 covers them all.
    A positive k_budget is compared with the JAX dense emit, whose
    overflow regime drops the tail of the last tiles, as the port does
    (the JAX compact emit would drop a depth tail instead)."""
    monkeypatch.setattr(JRS, "_EMIT_COMPACT", "0")
    a, js, ts = scene(seed=3)
    jcfg, tcfg = _configs(max_dup_per_gaussian=16, chunk_size=64,
                          downscale=downscale, opacity_radius=True,
                          max_active_tiles=max_active_tiles, k_budget=k_budget)
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    bg = np.full((12,), 0.7, np.float32)
    j_out, j_t, j_ovf, _ = JRS.blend_stream(
        jp, jnp.asarray(bg), 16, 4, jcfg, 12, interpret=True)
    before = TRS.LAUNCHES
    out, t, ovf = TRS.blend_stream(tp, torch.from_numpy(bg), 16, 4, tcfg, 12)
    assert TRS.LAUNCHES == before  # CPU tensors never reach the kernel
    p_out = 256 // downscale ** 2
    assert out.shape == (16, p_out, 12) and t.shape == (16, p_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), atol=1e-5)
    assert int(ovf) == int(j_ovf)
    if max_active_tiles == 8 or k_budget:
        assert int(ovf) > 0  # the budget really cut entries


def test_rasterize_gaussians_matches_xla_path():
    """The dispatcher and GaussianRasterizer vs gpcr_tpu's exact XLA path
    (what gpcr_tpu's renderer runs on the CPU)."""
    a, js, ts = scene(seed=5, H=48, W=80)
    jcfg, tcfg = _configs(max_dup_per_gaussian=16, chunk_size=64)
    ref, radii_ref, extra_ref = JR.rasterize_gaussians(
        jnp.asarray(a["means"]), jnp.asarray(a["op"]), js, config=jcfg,
        return_extra=True, **_jax_args(a))
    out, radii, extra = TR.rasterize_gaussians(
        torch.from_numpy(a["means"]), torch.from_numpy(a["op"]), ts,
        config=tcfg, return_extra=True, **_torch_args(a))
    assert out.shape == (12, 48, 80)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(extra["final_T"].numpy(),
                               np.asarray(extra_ref["final_T"]), atol=1e-5)
    np.testing.assert_array_equal(radii.numpy(), np.asarray(radii_ref))
    assert int(extra["dup_overflow"]) == int(extra_ref["dup_overflow"]) == 0

    rast = TR.GaussianRasterizer(ts, tcfg)
    out2, _ = rast(torch.from_numpy(a["means"]), None,
                   torch.from_numpy(a["op"]), **_torch_args(a))
    np.testing.assert_array_equal(out2.numpy(), out.numpy())
    with pytest.raises(ValueError):
        TR.rasterize_gaussians(torch.from_numpy(a["means"]),
                               torch.from_numpy(a["op"]), ts, config=tcfg)


def test_no_silent_device_switch(monkeypatch):
    """Tensors on a device without a blend raise; the CUDA build raises
    when nvcc is missing instead of falling back."""
    a, js, ts = scene(seed=6)
    _, tcfg = _configs(max_dup_per_gaussian=16, chunk_size=64)
    stream = torch.zeros((0, 20), device="meta")
    starts = torch.zeros((17,), dtype=torch.int32, device="meta")
    order = torch.zeros((16,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TRS.blend_tiles(stream, starts, order, 16, 4, 12, tcfg)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()


# --------------------------------------------------------------------------
# the serving kernel's cull predicate
# --------------------------------------------------------------------------


def _reach(rows, x0, y0):
    """(n, 8) bool: some pixel of each 8x4 block of the tile at (x0, y0)
    is not skipped by ``blend_tiles_plain``'s arithmetic (power <= 0 and
    alpha >= 1/255)."""
    p = torch.arange(256)
    lx, ly = (p % 16).to(torch.float32), (p // 16).to(torch.float32)
    dx = rows[:, 0:1] - (x0 + lx)[None]
    dy = rows[:, 1:2] - (y0 + ly)[None]
    power = (-0.5 * (rows[:, 2:3] * dx * dx + rows[:, 4:5] * dy * dy)
             - rows[:, 3:4] * dx * dy)
    alpha = torch.clamp(rows[:, 5:6] * torch.exp(power), max=0.99)
    kept = ~(power > 0.0) & ~(alpha < (1.0 / 255.0))
    block = (ly // 4).long() * 2 + (lx // 8).long()
    return torch.stack([kept[:, block == w].any(dim=1) for w in range(8)], 1)


def _adversarial_rows(seed, n=4000, x0=32.0, y0=48.0):
    """Stream rows built to sit on the predicate's edges: thin rotated
    conics (axis ratios up to 1e4), conics close to degenerate, opacities
    a hair above and below 1/255 and near 1, means on and around the
    tile's block edges, and rows no cull may touch (NaN, infinite or
    non-positive values, indefinite conics)."""
    rng = np.random.RandomState(seed)
    sig1 = 10.0 ** rng.uniform(-0.5, 1.5, n)
    sig2 = sig1 / 10.0 ** rng.uniform(0, 4, n)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = cs * cs * sig1 ** 2 + sn * sn * sig2 ** 2
    cyy = sn * sn * sig1 ** 2 + cs * cs * sig2 ** 2
    cxy = cs * sn * (sig1 ** 2 - sig2 ** 2)
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    kind = rng.randint(0, 4, n)
    op = np.where(kind == 0, rng.uniform(0, 1, n),
                  np.where(kind == 1, (1 + rng.uniform(-1e-3, 1e-3, n)) / 255,
                           np.where(kind == 2, 1 - rng.uniform(0, 1e-2, n),
                                    (1 + rng.uniform(0, 1e-6, n)) / 255)))
    # means on block edges (+- a pixel) or anywhere around the tile
    edge = np.stack([x0 + rng.choice([0, 7, 8, 15], n)
                     + rng.uniform(-1.5, 1.5, n),
                     y0 + rng.choice([0, 3, 4, 7, 8, 11, 12, 15], n)
                     + rng.uniform(-1.5, 1.5, n)], 1)
    wide = np.stack([x0 + rng.uniform(-40, 56, n),
                     y0 + rng.uniform(-40, 56, n)], 1)
    mean = np.where((rng.rand(n) < 0.5)[:, None], edge, wide)
    rows = np.concatenate([mean, conic, op[:, None]], 1).astype(np.float32)
    # near-degenerate: push b^2 towards a * c
    k = n // 10
    rows[:k, 3] = (np.sign(rng.randn(k)) * np.sqrt(rows[:k, 2] * rows[:k, 4])
                   * (1 - 10.0 ** rng.uniform(-6, -1, k))).astype(np.float32)
    special = np.array([
        [x0 + 4, y0 + 2, 0.5, 0.0, 0.5, np.nan],
        [np.nan, y0, 0.5, 0.0, 0.5, 0.9],
        [x0, y0, np.inf, 0.0, 0.5, 0.9],
        [x0 + 4, y0 + 2, 0.5, 0.0, 0.5, np.inf],
        [x0 + 4, y0 + 2, 0.5, 0.0, 0.5, 0.0],
        [x0 + 4, y0 + 2, 0.5, 0.0, 0.5, -0.3],
        [x0 + 4, y0 + 2, -0.5, 0.0, 0.5, 0.9],
        [x0 + 4, y0 + 2, 0.5, 0.9, 0.5, 0.9],
        [x0 + 60, y0 + 2, 1e-8, 0.0, 1e-8, 0.9],
    ], np.float32)
    return torch.from_numpy(np.concatenate([rows, special]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_predicate_never_drops_a_kept_pair(seed):
    """No (entry, block) pair that ``block_mask_plain`` culls holds a
    pixel the plain version composites; on the adversarial rows and on a
    preprocessed scene's stream the predicate still culls most pairs."""
    x0, y0 = 32.0, 48.0
    rows = _adversarial_rows(seed, x0=x0, y0=y0)
    mask = TRS.block_mask_plain(rows, x0, y0)
    reach = _reach(rows, x0, y0)
    assert mask.shape == (rows.shape[0], 8)
    assert not bool((reach & ~mask).any()), torch.nonzero(reach & ~mask)[:5]
    assert bool(reach.any()) and float((~mask).float().mean()) > 0.3
    special = mask[-9:]  # NaN / inf / indefinite keep every block ...
    assert bool(special[[0, 1, 2, 3, 6, 7]].all())
    assert not bool(special[[4, 5]].any())  # ... op <= 0 none
    assert bool(special[8].all())  # a huge splat reaches every block

    a, _, ts = scene(seed=seed)
    _, tcfg = _configs(max_dup_per_gaussian=16, chunk_size=64,
                       opacity_radius=True)
    prep = TR.preprocess(torch.from_numpy(a["means"]),
                         torch.from_numpy(a["op"]), ts, tcfg, **_torch_args(a))
    stream, starts, _ = TRS.bin_sorted_stream(prep, 16, 4, tcfg)
    culled = 0
    for tile in range(16):
        s, e = int(starts[tile]), int(starts[tile + 1])
        tx, ty = float(tile % 4 * 16), float(tile // 4 * 16)
        m = TRS.block_mask_plain(stream[s:e], tx, ty)
        assert not bool((_reach(stream[s:e], tx, ty) & ~m).any())
        culled += int((~m).sum())
    assert culled > 0.3 * 8 * int(starts[-1])


def test_ab_source_copies_undo_one_step_each(tmp_path):
    """``cli/ab_sources.py`` (the per-step A/B copies of the ring kernels)
    still applies to this tree: each copy differs from it in the shared
    header only, and no two copies are equal."""
    from gpcr_tpu_torch.cli import ab_sources

    dirs = ab_sources.write(str(tmp_path))
    assert sorted(dirs) == sorted(ab_sources.STEPS)
    own = {n: open(os.path.join(cuda_build.CSRC_DIR, n)).read()
           for n in ab_sources.FILES}
    headers = set()
    for d in dirs.values():
        got = {n: open(os.path.join(d, n)).read() for n in ab_sources.FILES}
        assert got["stream_blend.cu"] == own["stream_blend.cu"]
        assert got["aligned_blend.cu"] == own["aligned_blend.cu"]
        assert got["blend_common.cuh"] != own["blend_common.cuh"]
        headers.add(got["blend_common.cuh"])
    assert len(headers) == len(dirs)

"""Port parity: the (tile, depth) binning, the chunk-aligned layout and the
all-tiles blend of ``gpcr_tpu_torch.ops.rasterize_aligned`` against
``gpcr_tpu.ops.rasterize_pallas`` (its Pallas kernel in interpret mode, as
tests/test_pallas.py runs it).

Tolerances: binning is exact (sorted order, starts, chunk starts, overflow
equal; the layout's data fields bit-equal). Blended images at atol 2e-4 /
rtol 1e-3, the tests/test_pallas.py bar: the port's transmittance is a
sequential float32 product, the TPU kernel's an exp of a cumulative sum of
logs, so a pixel at the 1e-4 termination threshold may stop one entry
apart. Against the port's own stream route (the same sequential products)
at atol 1e-5.

The CUDA kernel itself is checked against the plain version on the card
by tests/test_torch_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import rasterize_pallas as JRP
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_aligned as TRA
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.render.renderer import pin_fp32

from test_rasterize import make_camera_matrices, random_scene
from test_torch_stream import _adversarial_rows, _configs, _preps, scene

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card


def _binning_scene(equal_depths, k_budget=None):
    a, js, ts = scene(seed=1)
    a["scales"][:, 0] *= 3.0  # anisotropic: multi-tile rects and dup-cap hits
    if k_budget is not None:
        # the JAX compact emit (rasterize.py:277-280) numbers its slots by
        # the gaussians that emit at all, so it reads the wrong rects once a
        # gaussian without tiles comes first; its rule (the first k_budget
        # slots in emit order) is compared where every gaussian emits
        a["valid"][:] = True
    if equal_depths:
        # the view matrix is the identity, so depth is z: a quantized cloud
        # whose (tile, depth) ties must keep emit order
        a["means"][:, 2] = np.round(a["means"][:, 2] * 4) / 4
    return a, js, ts


@pytest.mark.parametrize("equal_depths", [False, True])
@pytest.mark.parametrize("k_budget", [None, 300])
def test_tile_bin_matches_jax_exactly(k_budget, equal_depths):
    a, js, ts = _binning_scene(equal_depths, k_budget)
    jcfg, tcfg = _configs(max_dup_per_gaussian=8, chunk_size=16,
                          k_budget=k_budget)
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    assert k_budget is None or bool(np.asarray(jp.valid).all())
    if equal_depths:
        assert len(np.unique(np.asarray(jp.depth))) < 20
    gidx, starts, ovf = TR.tile_bin(tp, 16, 4, tcfg)
    j_gidx, j_starts, j_ovf = JR.tile_bin(jp, 16, 4, jcfg)
    total = int(starts[-1])
    assert total == gidx.numel() > 0
    # a budget below the entry count cuts in emit order and counts the rest
    emitted = int(JR.entry_count(jp, jcfg))
    assert total == (emitted if k_budget is None else k_budget) <= emitted
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(j_gidx)[:total])
    assert int(ovf) == int(j_ovf) > 0


@pytest.mark.parametrize(
    "k_budget,max_active_tiles", [(None, None), (300, None), (64, 2)])
def test_tile_bin_aligned_matches_jax_exactly(k_budget, max_active_tiles):
    a, js, ts = _binning_scene(True, k_budget)
    jcfg, tcfg = _configs(max_dup_per_gaussian=8, chunk_size=16,
                          k_budget=k_budget,
                          max_active_tiles=max_active_tiles)
    jp, tp = _preps(a, js, ts, jcfg, tcfg)
    assert k_budget is None or bool(np.asarray(jp.valid).all())
    channels = a["feats"].shape[1]
    scal, feat, cstarts, ovf = TRA.tile_bin_aligned(tp, 16, 4, tcfg)
    j_scal, j_feat, j_cstarts, j_ovf = JRP.tile_bin_aligned(jp, 16, 4, jcfg, 16)
    np.testing.assert_array_equal(cstarts.numpy(), np.asarray(j_cstarts))
    assert int(ovf) == int(j_ovf) > 0
    kc = int(cstarts[-1])
    assert scal.shape == (kc, 6, 16) and feat.shape == (kc, channels, 16)
    assert kc > 0
    # the fields that carry data: the JAX layout pads 6 -> 8 rows, C -> c_pad
    # channels and the chunk axis to its static bound
    np.testing.assert_array_equal(scal.numpy(), np.asarray(j_scal)[:kc, :6])
    np.testing.assert_array_equal(feat.numpy(),
                                  np.asarray(j_feat)[:kc, :channels])
    if max_active_tiles is not None:
        # the clamp cut whole tiles: the layout ends at the static bound
        assert kc * 16 == 64 + max_active_tiles * 16
        assert int(ovf) > int(TR.tile_bin(tp, 16, 4, tcfg)[2])


def _pallas_scene(name):
    """The two scenes of tests/test_pallas.py: a random one and an
    over-drawn stack that takes the early-termination path."""
    if name == "random":
        W = H = 48
        means, scales, rots, ops_, feats = random_scene(60, seed=5)
        eye, bg = [0.0, 0.0, -2.5], np.array([0.1, 0.2, 0.3], np.float32)
        cfg = dict(max_dup_per_gaussian=32, chunk_size=32, tile_batch=4)
    else:
        W = H = 32
        n = 48
        rng = np.random.RandomState(3)
        means = (rng.randn(n, 3) * 0.01).astype(np.float32)
        means[:, 2] = np.linspace(-0.3, 0.3, n)
        scales = np.full((n, 3), 0.15, np.float32)
        rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        ops_ = np.full((n,), 0.95, np.float32)
        feats = rng.rand(n, 3).astype(np.float32)
        eye, bg = [0.0, 0.0, -2.0], np.zeros(3, np.float32)
        cfg = dict(max_dup_per_gaussian=16, chunk_size=16, tile_batch=4)
    view_t, full_t, tanfov, campos = make_camera_matrices(eye, W, H)
    js = JR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=tanfov, tanfovy=tanfov,
        bg=jnp.asarray(bg), scale_modifier=1.0, viewmatrix=view_t,
        projmatrix=full_t, sh_degree=0, campos=campos)
    ts = TR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=tanfov, tanfovy=tanfov,
        bg=torch.from_numpy(bg), scale_modifier=1.0,
        viewmatrix=torch.from_numpy(np.array(view_t)),
        projmatrix=torch.from_numpy(np.array(full_t)), sh_degree=0,
        campos=torch.from_numpy(np.array(campos)))
    return (means, scales, rots, ops_, feats), js, ts, cfg


@pytest.mark.parametrize("name", ["random", "overdraw"])
def test_blend_aligned_matches_pallas_interpret(name):
    (means, scales, rots, ops_, feats), js, ts, cfg = _pallas_scene(name)
    jcfg, tcfg = _configs(**cfg)
    ref, ref_radii = JRP.rasterize_gaussians_pallas(
        jnp.asarray(means), jnp.asarray(ops_), js,
        scales=jnp.asarray(scales), rotations=jnp.asarray(rots),
        colors_precomp=jnp.asarray(feats), config=jcfg, interpret=True)
    targs = dict(scales=torch.from_numpy(scales),
                 rotations=torch.from_numpy(rots),
                 colors_precomp=torch.from_numpy(feats), config=tcfg)
    got, radii = TRA.rasterize_gaussians_aligned(
        torch.from_numpy(means), torch.from_numpy(ops_), ts, **targs)
    assert got.shape == (3, ts.image_height, ts.image_width)
    np.testing.assert_array_equal(radii.numpy(), np.asarray(ref_radii))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)
    assert float((got - ts.bg[:, None, None]).abs().max()) > 0.1
    # the port's stream route blends the same entries in the same order
    stream, _ = TRS.rasterize_gaussians_stream(
        torch.from_numpy(means), torch.from_numpy(ops_), ts, **targs)
    np.testing.assert_allclose(got.numpy(), stream.numpy(), atol=1e-5)


def test_blend_aligned_plain_on_its_layout():
    """The wrapper's outputs per tile: an empty tile keeps acc 0 and T 1,
    a finished pixel keeps the T it had before the crossing entry, and
    ``blend_aligned`` adds T * bg."""
    (means, scales, rots, ops_, feats), _, ts, cfg = _pallas_scene("overdraw")
    tcfg = TR.RasterizeConfig(**cfg)
    half = means.copy()
    half[:, 0] -= 0.45  # off to one side: the other side's tiles stay empty
    prep = TR.preprocess(
        torch.from_numpy(half), torch.from_numpy(ops_), ts, tcfg,
        scales=torch.from_numpy(scales) * 0.3,
        rotations=torch.from_numpy(rots),
        colors_precomp=torch.from_numpy(feats))
    scal, feat, cstarts, _ = TRA.tile_bin_aligned(prep, 4, 2, tcfg)
    acc, t = TRA.blend_aligned_tiles(cstarts, scal, feat, 4, 2, 3, tcfg)
    assert acc.shape == (4, 256, 3) and t.shape == (4, 256)
    n_chunks = (cstarts[1:] - cstarts[:-1]).numpy()
    assert (n_chunks == 0).any() and (n_chunks > 1).any()
    empty = torch.from_numpy(n_chunks == 0)
    assert float(acc[empty].abs().max()) == 0 and bool((t[empty] == 1).all())
    # 48 stacked splats of opacity 0.95 end every central pixel early:
    # T stops at or above the 1e-4 threshold, never below it
    assert float(t.min()) >= 1e-4 and float(t.min()) < 1e-2
    bg = torch.tensor([0.2, 0.5, 0.9])
    out, t2, ovf = TRA.blend_aligned(prep, bg, 4, 2, tcfg, 3)
    assert int(ovf) == 0  # the aligned core drops the binning's overflow
    np.testing.assert_array_equal(t2.numpy(), t.numpy())
    np.testing.assert_allclose(
        out.numpy(), (acc + t[..., None] * bg).numpy(), atol=0)


def test_aligned_order_is_longest_first_with_empty_tiles_last():
    """The CUDA kernel's tile order: every tile once, by descending chunk
    count, ties by ascending id, so the empty tiles come last."""
    n_chunks = np.random.RandomState(0).choice([0, 0, 1, 2, 3, 7], 300)
    cstarts = torch.from_numpy(
        np.concatenate([[0], np.cumsum(n_chunks)]).astype(np.int32))
    order = TRA.aligned_order(cstarts)
    assert order.dtype == torch.int32
    ids = order.numpy()
    assert sorted(ids.tolist()) == list(range(300))
    got = n_chunks[ids]
    assert (np.diff(got) <= 0).all()
    n_empty = int((n_chunks == 0).sum())
    assert n_empty > 0 and (got[-n_empty:] == 0).all()
    for v in np.unique(n_chunks):
        assert (np.diff(ids[got == v]) > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planar_cull_predicate_equals_the_row_form(seed):
    """The kernel's cull predicate on the planar layout (the value
    overload of ``block_mask``) is the row form's on the adversarial rows
    (near-degenerate conics, opacities around 1/255, zero and NaN
    opacities, means far off the tile); the zero slots that pad a chunk
    are culled for every block."""
    x0, y0 = 32.0, 48.0
    rows = _adversarial_rows(seed, x0=x0, y0=y0)
    n, ch = rows.shape[0], 64
    slots = torch.zeros((-(-n // ch) * ch, 6))
    slots[:n] = rows
    scal = slots.reshape(-1, ch, 6).transpose(1, 2).contiguous()
    got = TRA.block_mask_planar_plain(scal, x0, y0).reshape(-1, 8)
    assert torch.equal(got[:n], TRS.block_mask_plain(rows, x0, y0))
    assert not bool(got[n:].any())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    tcfg = TR.RasterizeConfig(chunk_size=16)
    scal = torch.zeros(2, 6, 16)
    feat = torch.zeros(2, 3, 16)
    cstarts = torch.tensor([0, 1, 2], dtype=torch.int32)
    check = functools.partial(TRA._check_inputs, num_tiles=2, channels=3)
    check(cstarts, scal, feat, config=tcfg)
    with pytest.raises(ValueError, match="16x16"):
        check(cstarts, scal, feat, config=tcfg._replace(tile_x=8))
    with pytest.raises(TypeError, match="chunk_starts"):
        check(cstarts.long(), scal, feat, config=tcfg)
    with pytest.raises(ValueError, match="scal must be"):
        check(cstarts, scal[:, :5], feat, config=tcfg)
    with pytest.raises(ValueError, match="feat must be"):
        check(cstarts, scal, feat[:1], config=tcfg)
    with pytest.raises(ValueError, match="contiguous"):
        check(cstarts, scal, feat.transpose(1, 2).contiguous().transpose(1, 2),
              config=tcfg)
    with pytest.raises(ValueError, match="channels"):
        TRA._check_inputs(cstarts, scal, torch.zeros(2, 17, 16), 2, 17, tcfg)

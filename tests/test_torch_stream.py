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

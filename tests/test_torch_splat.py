"""Port parity: SH, splat math, preprocess and the camera path of
``gpcr_tpu_torch`` against ``gpcr_tpu`` on the same numpy inputs.

Tolerances: float32 elementwise math at rtol 1e-5 / atol 1e-6 (the two
frameworks may contract or reorder a few float ops); integer rects and
validity masks must be equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import splat as JS
from gpcr_tpu.render import renderer as JRD
from gpcr_tpu.structures import trajectory as JT
from gpcr_tpu.utils import rigid_motion as JRM
from gpcr_tpu.utils import sh as JSH
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import splat as TS
from gpcr_tpu_torch.render import renderer as TRD
from gpcr_tpu_torch.structures import trajectory as TT
from gpcr_tpu_torch.utils import rigid_motion as TRM
from gpcr_tpu_torch.utils import sh as TSH
from gpcr_tpu_torch.render.renderer import pin_fp32

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(ref), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# SH
# --------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    k = (deg + 1) ** 2
    sh = rng.randn(64, 3, k).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    _close(TSH.eval_sh(deg, _t(sh), _t(dirs)), ref)
    assert TSH.sh_dim_num(deg) == JSH.sh_dim_num(deg)


def test_eval_sh_color_and_dc_roundtrip():
    rng = np.random.RandomState(1)
    sh = rng.randn(50, 16, 3).astype(np.float32)
    means = rng.randn(50, 3).astype(np.float32)
    campos = np.array([0.3, -2.0, 0.5], np.float32)
    ref = JSH.eval_sh_color(3, jnp.asarray(sh), jnp.asarray(means),
                            jnp.asarray(campos))
    _close(TSH.eval_sh_color(3, _t(sh), _t(means), _t(campos)), ref)
    rgb = rng.rand(32, 3).astype(np.float32)
    _close(TSH.RGB2SH(_t(rgb)), JSH.RGB2SH(jnp.asarray(rgb)))
    _close(TSH.SH2RGB(TSH.RGB2SH(_t(rgb))), rgb, atol=1e-6)
    with pytest.raises(ValueError):
        TSH.eval_sh(5, _t(sh), _t(means))


# --------------------------------------------------------------------------
# splat math
# --------------------------------------------------------------------------


def _splat_inputs(seed=0, n=300):
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.4 + np.array([0, 0, 2.5])).astype(np.float32)
    scales = (rng.rand(n, 3) * 0.05 + 0.005).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    op = rng.rand(n).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[3, :3] = rng.randn(3) * 0.05  # small translation (transposed layout)
    return means, scales, quats, op, view


def test_cov_chain_matches_jax():
    means, scales, quats, _, view = _splat_inputs()
    _close(TS.quat_to_rotmat(_t(quats)), JS.quat_to_rotmat(jnp.asarray(quats)))
    c3_ref = JS.compute_cov3d(jnp.asarray(scales), 1.3, jnp.asarray(quats))
    c3 = TS.compute_cov3d(_t(scales), 1.3, _t(quats))
    _close(c3, c3_ref)
    c2_ref = JS.compute_cov2d(jnp.asarray(means), 70.0, 80.0, 0.6, 0.7,
                              c3_ref, jnp.asarray(view))
    _close(TS.compute_cov2d(_t(means), 70.0, 80.0, 0.6, 0.7, c3, _t(view)),
           c2_ref)


def test_projection_and_cull_match_jax():
    means, _, _, _, view = _splat_inputs(seed=2)
    means[:20, 2] = 0.1  # behind the near plane
    proj = np.asarray(JRD.get_projection_matrix(0.01, 100.0, 0.8, 0.8)).T
    full = (view @ proj).astype(np.float32)
    _close(TS.project_points(_t(means), _t(full)),
           JS.project_points(jnp.asarray(means), jnp.asarray(full)))
    pv, vis = TS.in_frustum(_t(means), _t(view))
    jpv, jvis = JS.in_frustum(jnp.asarray(means), jnp.asarray(view))
    _close(pv, jpv)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    _close(TS.ndc2pix(_t(means[:, 0]), 64), JS.ndc2pix(jnp.asarray(means[:, 0]), 64))


@pytest.mark.parametrize("with_opacity", [False, True])
def test_conic_radius_rect_match_jax(with_opacity):
    rng = np.random.RandomState(3)
    a = rng.rand(200).astype(np.float32) * 40 + 0.5
    c = rng.rand(200).astype(np.float32) * 40 + 0.5
    b = (rng.rand(200).astype(np.float32) - 0.5) * np.sqrt(a * c)
    cov2d = np.stack([a, b, c], -1).astype(np.float32)
    cov2d[:5] = 0.0  # singular -> det_valid False
    op = rng.rand(200).astype(np.float32)
    op[:10] = 0.002  # below 1/255: culled by the tight radius
    kw = {"opacity": op} if with_opacity else {}
    ref = JS.conic_and_radius(jnp.asarray(cov2d),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = TS.conic_and_radius(_t(cov2d), **{k: _t(v) for k, v in kw.items()})
    assert len(got) == len(ref)
    _close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    xy = (rng.rand(200, 2) * 80 - 8).astype(np.float32)
    r = 3 if with_opacity else 1  # the binning radius
    rect_ref = JS.get_rect(jnp.asarray(xy), ref[r], 5, 4, 16, 16)
    rect = TS.get_rect(_t(xy), got[r], 5, 4, 16, 16)
    for g, r in zip(rect, rect_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# --------------------------------------------------------------------------
# preprocess
# --------------------------------------------------------------------------


def _settings_pair(view, tanfov=0.9, H=80, W=96, channels=12):
    proj = np.asarray(JRD.get_projection_matrix(
        0.01, 100.0, 2 * math.atan(tanfov), 2 * math.atan(tanfov))).T
    full = (view @ proj).astype(np.float32)
    bg = np.full((channels,), 0.3, np.float32)
    campos = np.zeros(3, np.float32)
    js = JR.GaussianRasterizationSettings(
        H, W, tanfov, tanfov, jnp.asarray(bg), 1.0, jnp.asarray(view),
        jnp.asarray(full), 1, jnp.asarray(campos))
    ts = TR.GaussianRasterizationSettings(
        H, W, tanfov, tanfov, _t(bg), 1.0, _t(view), _t(full), 1, _t(campos))
    return js, ts


@pytest.mark.parametrize("opacity_radius", [False, True])
def test_preprocess_matches_jax(opacity_radius):
    means, scales, quats, op, view = _splat_inputs(seed=4, n=400)
    rng = np.random.RandomState(5)
    valid = rng.rand(400) > 0.1
    shs = rng.randn(400, 4, 3).astype(np.float32)
    js, ts = _settings_pair(view)
    jcfg = JR.RasterizeConfig(opacity_radius=opacity_radius)
    tcfg = TR.RasterizeConfig(opacity_radius=opacity_radius)
    ref = JR.preprocess(jnp.asarray(means), jnp.asarray(op), js, jcfg,
                        scales=jnp.asarray(scales),
                        rotations=jnp.asarray(quats), shs=jnp.asarray(shs),
                        valid_mask=jnp.asarray(valid))
    got = TR.preprocess(_t(means), _t(op), ts, tcfg, scales=_t(scales),
                        rotations=_t(quats), shs=_t(shs), valid_mask=_t(valid))
    for name in ("depth", "mean2d", "conic", "features", "opacity"):
        _close(getattr(got, name), getattr(ref, name))
    for name in ("valid", "radius", "rect"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert int(TR.entry_count(got, tcfg)) == int(JR.entry_count(ref, jcfg))
    assert got.valid.any() and not got.valid.all()


# --------------------------------------------------------------------------
# cameras
# --------------------------------------------------------------------------


def test_circle_trajectory_and_raster_params_match_jax():
    params = {"d": 0, "r": 3, "center_angles": [90, 0]}
    jtraj = JT.CameraTrajectory("circle", n_imgs=5, total=1, params=params)
    ttraj = TT.CameraTrajectory("circle", n_imgs=5, total=1, params=params)
    jcam = jtraj.get_camera(fov=45, width_px=64, height_px=48)
    tcam = ttraj.get_camera(fov=45, width_px=64, height_px=48)
    _close(tcam.H_c2w, jcam.H_c2w)
    _close(tcam.intrinsic, jcam.intrinsic)
    _close(tcam.get_H_w2c(), jcam.get_H_w2c())
    _close(TRM.inv_homogeneous(tcam.H_c2w), JRM.inv_homogeneous(jcam.H_c2w))
    assert tcam[0].H_c2w.shape == (1, 5, 4, 4)

    jrp = JRD.get_rasterize_param_from_camera(jcam, 45, sh_degree=1)
    trp = TRD.get_rasterize_param_from_camera(tcam, 45, sh_degree=1)
    for k in ("view_t", "full_t", "campos", "bg"):
        _close(trp[k], jrp[k])
    for k in ("tanfov", "height", "width", "sh_degree"):
        assert trp[k] == jrp[k], k
    # the fixed six views, and manual eyes in a global frame
    radii = {"min_r": 3, "max_r": 4}
    _close(TT.CameraTrajectory("udlrfb", n_imgs=6, total=1,
                               params=radii).cam_poses,
           JT.CameraTrajectory("udlrfb", n_imgs=6, total=1,
                               params=radii).cam_poses)
    manual = {"eye": ["0 0 3", "2.5 0.4 0", "-1 2 1.5"], "up": ["0 1 0"],
              "look_at": ["0.1 0 0"], "t_c2w": "0.2 0 0.1",
              "y_c2w": "0 1 0.2", "z_c2w": "0.1 0 1"}
    _close(TT.CameraTrajectory("manual", n_imgs=3, total=2,
                               params=manual).cam_poses,
           JT.CameraTrajectory("manual", n_imgs=3, total=2,
                               params=manual).cam_poses)


def test_unpack_sym6_matches_jax():
    c6 = np.random.RandomState(4).randn(5, 2, 6).astype(np.float32)
    got = TS.unpack_sym6(torch.from_numpy(c6)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.unpack_sym6(jnp.asarray(c6))))
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))

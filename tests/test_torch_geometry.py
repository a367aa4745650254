"""The port's segment max / min, ray and camera geometry, sampling, debug
and timing utilities and the checkpoint / LPIPS converters against
``gpcr_tpu`` on the same seeded numpy inputs; and the rasterizer's
``debug`` flag in both packages.

Tolerances: exact for indices, masks, segment reductions and numpy
copies; 1e-6 for float32 elementwise work (distances, t, uv sampling,
capture geometry); 1e-5 for projections. Random draws (shuffles, vMF
samples) are held to their properties, and the vMF map from uniforms to
directions to JAX's formula on the same uniforms at 1e-6.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import segment as JSEG
from gpcr_tpu.render import checkpoint as JCK
from gpcr_tpu.utils import debug as JDBG
from gpcr_tpu.utils import geometry as JG
from gpcr_tpu.utils import rigid_motion as JRM
from gpcr_tpu.utils import sampling as JS
from gpcr_tpu_torch.metrics import lpips as TLP
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import segment as TSEG
from gpcr_tpu_torch.render import checkpoint as TCK
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.utils import debug as TDBG
from gpcr_tpu_torch.utils import geometry as TG
from gpcr_tpu_torch.utils import sampling as TS
from gpcr_tpu_torch.utils import timing as TT

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()


def _rays(m=40, n=3000, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    o = (rng.randn(m, 3) * 2).astype(np.float32)
    d = rng.randn(m, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pts, o, d


# --------------------------------------------------------------------------
# segment max / min
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["segment_max", "segment_min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_max_min_match_jax_with_empty_segments(op, dtype):
    rng = np.random.RandomState(3)
    data = (rng.randn(200, 4) * 100).astype(dtype)
    ids = rng.randint(0, 30, 200)
    ids[ids % 7 == 3] = 0  # segments 3, 10, 17, 24 stay empty
    want = np.asarray(getattr(JSEG, op)(jnp.asarray(data), jnp.asarray(ids), 33))
    got = getattr(TSEG, op)(torch.from_numpy(data), torch.from_numpy(ids), 33)
    assert got.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.float32:
        empty = -np.inf if op == "segment_max" else np.inf
    else:
        info = np.iinfo(np.int32)
        empty = info.min if op == "segment_max" else info.max
    assert (want[[3, 10, 17, 24, 30, 32]] == empty).all()


# --------------------------------------------------------------------------
# ray geometry
# --------------------------------------------------------------------------


def test_ray_aabb_matches_jax():
    rng = np.random.RandomState(1)
    o = (rng.randn(2, 50, 3) * 3).astype(np.float32)
    d = rng.randn(2, 50, 3).astype(np.float32)
    d[0, :5, 0] = 0.0  # axis-parallel rays: inf / nan slabs
    lo = np.array([-1.0, -0.5, -2.0], np.float32)
    hi = np.array([1.0, 1.5, 0.5], np.float32)
    kw = dict(bbox_scaling_ratio=1.2, t_min=0.1, t_max=20.0)
    want = JG.ray_aabb_intersection(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(lo), jnp.asarray(hi), **kw)
    got = TG.ray_aabb_intersection(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(lo), torch.from_numpy(hi),
                                   **kw)
    np.testing.assert_array_equal(got["is_intersected"].numpy(),
                                  np.asarray(want["is_intersected"]))
    for k in ("t_near", "t_far"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_point_ray_distance_and_rectify_match_jax():
    pts, o, d = _rays(m=12, n=300)
    args_j = (jnp.asarray(pts), jnp.asarray(o), jnp.asarray(d))
    args_t = (torch.from_numpy(pts), torch.from_numpy(o), torch.from_numpy(d))
    want, got = JG.compute_point_ray_distance(*args_j), TG.compute_point_ray_distance(*args_t)
    for k in ("dists", "ts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)
    np.testing.assert_allclose(got["projections"].numpy(),
                               np.asarray(want["projections"]), atol=1e-5)
    want, got = JG.rectify_points(*args_j), TG.rectify_points(*args_t)
    np.testing.assert_allclose(got["ts"].numpy(), np.asarray(want["ts"]), atol=1e-6)
    np.testing.assert_allclose(got["perp"].numpy(), np.asarray(want["perp"]), atol=1e-5)


def _knn_pair(pts, o, d, k, **kw):
    jkw = {key: (jnp.asarray(v) if key == "t_init" else v) for key, v in kw.items()}
    tkw = {key: (torch.from_numpy(v) if key == "t_init" else v) for key, v in kw.items()}
    want = JG.get_k_neighbor_points(jnp.asarray(pts)[None], jnp.asarray(o)[None],
                                    jnp.asarray(d)[None], k=k, **jkw)
    got = TG.get_k_neighbor_points(torch.from_numpy(pts)[None],
                                   torch.from_numpy(o)[None],
                                   torch.from_numpy(d)[None], k=k, **tkw)
    return want, got


def _assert_knn_equal(got, want):
    np.testing.assert_array_equal(got["sorted_idxs"].numpy(),
                                  np.asarray(want["sorted_idxs"]))
    for k in ("sorted_dists", "sorted_ts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)


@pytest.mark.parametrize("window", ["wide", "narrow", "t_init"])
def test_k_neighbor_points_matches_jax(window):
    """'narrow' leaves fewer than k points inside most rays' t window: the
    rest tie at +inf and must come in ascending index, as lax.top_k
    orders them."""
    pts, o, d = _rays()
    kw = {"wide": dict(t_min=0.0, t_max=100.0),
          "narrow": dict(t_min=2.0, t_max=2.05),
          "t_init": dict(t_init=np.random.RandomState(5).rand(1, 40)
                         .astype(np.float32) * 3)}[window]
    want, got = _knn_pair(pts, o, d, 8, **kw)
    _assert_knn_equal(got, want)
    if window == "narrow":  # most of the 40 x 8 slots tie at +inf
        assert int(np.isinf(np.asarray(want["sorted_dists"])).sum()) > 160


@pytest.mark.parametrize("chunk_rays", [7, 64])
def test_k_neighbor_points_in_chunks_matches_unchunked(chunk_rays):
    pts, o, d = _rays()
    t = [torch.from_numpy(a)[None] for a in (pts, o, d)]
    whole = TG.get_k_neighbor_points(*t, k=6, t_min=0.5, t_max=4.0)
    got = TG.get_k_neighbor_points_in_chunks(*t, k=6, chunk_rays=chunk_rays,
                                             t_min=0.5, t_max=4.0)
    for k in whole:
        assert torch.equal(got[k], whole[k]), k
    want = JG.get_k_neighbor_points_in_chunks(
        *[jnp.asarray(a)[None] for a in (pts, o, d)], k=6,
        chunk_rays=chunk_rays, t_min=0.5, t_max=4.0)
    _assert_knn_equal(got, want)


def _cams(q=3):
    eyes = np.array([[0.0, 0.3, -2.5], [2.0, 0.5, 1.0], [-1.0, -1.0, 2.0]],
                    np.float32)[:q]
    H = np.asarray(JRM.get_H_c2w_lookat(jnp.asarray(eyes), jnp.zeros((q, 3)),
                                        jnp.asarray([[0.0, 1.0, 0.0]] * q)))
    K = np.array([[40.0, 0, 32], [0, 44.0, 24], [0, 0, 1]], np.float32)
    return H.copy(), np.broadcast_to(K, (q, 3, 3)).copy()


def test_pinhole_projection_and_corresponding_uv_match_jax():
    H, K = _cams()
    xyz = np.random.RandomState(2).randn(3, 200, 3).astype(np.float32)
    want = JG.find_corresponding_uv(jnp.asarray(xyz), jnp.asarray(K),
                                    jnp.asarray(H), 64, 48)
    got = TG.find_corresponding_uv(torch.from_numpy(xyz), torch.from_numpy(K),
                                   torch.from_numpy(H), 64, 48)
    np.testing.assert_allclose(got["uv"].numpy(), np.asarray(want["uv"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), atol=1e-5)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert 0 < got["valid"].float().mean() < 1
    p = TG.pinhole_projection(torch.from_numpy(xyz), torch.from_numpy(K),
                              torch.from_numpy(H))
    np.testing.assert_array_equal(p["in_front"].numpy(), got["z"].numpy() > 0)


@pytest.mark.parametrize("batched", [False, True])
def test_uv_sampling_matches_jax_edge_clamping(batched):
    rng = np.random.RandomState(4)
    fmap = rng.rand(*((2,) if batched else ()), 12, 16, 5).astype(np.float32)
    uv = np.stack([rng.uniform(-3, 19, (*((2,) if batched else ()), 300)),
                   rng.uniform(-3, 15, (*((2,) if batched else ()), 300))],
                  -1).astype(np.float32)  # beyond every edge
    want = JG.uv_sampling(jnp.asarray(fmap), jnp.asarray(uv))
    got = TG.uv_sampling(torch.from_numpy(fmap), torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_zdir_dps_matches_jax():
    H, K = _cams()
    z = np.random.RandomState(6).uniform(1, 4, (3, 6, 8)).astype(np.float32)
    want = JG.compute_3d_zdir_and_dps(jnp.asarray(z), jnp.asarray(K), jnp.asarray(H))
    got = TG.compute_3d_zdir_and_dps(torch.from_numpy(z), torch.from_numpy(K),
                                     torch.from_numpy(H))
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["random", "latin_hypercube"])
def test_get_samples_and_dtype_maps_match_jax(method):
    kw = dict(method=method, seed=3, low=[0.0, -1.0, 2.0], high=[1.0, 1.0, 5.0])
    got = TS.get_samples(64, 3, **kw)
    np.testing.assert_array_equal(got, JS.get_samples(64, 3, **kw))
    assert got.dtype == np.float32
    for name in ("float32", "int64", "bool", np.float16):
        assert TS.get_np_dtype(name) == JS.get_np_dtype(name)
        assert TS.get_torch_dtype(name) == getattr(torch, np.dtype(name).name)
    assert TS.get_np_dtype(torch.int32) == np.int32
    assert TS.get_torch_dtype(torch.float64) is torch.float64


def test_shuffle_along_axis_permutes_each_slice():
    a = torch.arange(60).reshape(3, 4, 5)
    g = torch.Generator().manual_seed(0)
    for axis in (0, 2):
        b = TS.shuffle_along_axis(g, a, axis=axis)
        assert torch.equal(torch.sort(b, dim=axis).values, a)
        assert not torch.equal(b, a)
    # the JAX function's property, on the same array
    jb = JS.shuffle_along_axis(jax.random.PRNGKey(0), jnp.asarray(a.numpy()), axis=1)
    np.testing.assert_array_equal(np.sort(np.asarray(jb), axis=1), a.numpy())


def _jax_vmf_direction(kappa, u, phi, mu):
    """gpcr_tpu/utils/sampling.py's SphericalGaussian.sample after its
    draws, on given uniforms."""
    k = kappa
    w = 1.0 + jnp.log(u + (1.0 - u) * jnp.exp(-2.0 * k)) / k
    s = jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0))
    v_local = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), w], axis=-1)
    z = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), mu.shape)
    return (JRM.get_min_R(z, mu) @ v_local[..., None])[..., 0]


def test_spherical_gaussian_matches_jax_and_its_moments():
    kappa = 20.0
    rng = np.random.RandomState(7)
    mu = rng.randn(500, 3).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    u = rng.uniform(1e-7, 1.0, 500).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 500).astype(np.float32)
    sg, jsg = TS.SphericalGaussian(kappa), JS.SphericalGaussian(kappa)
    got = sg.direction(torch.from_numpy(u), torch.from_numpy(phi), torch.from_numpy(mu))
    want = _jax_vmf_direction(kappa, jnp.asarray(u), jnp.asarray(phi), jnp.asarray(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x = np.roll(mu, 1, axis=0)
    np.testing.assert_allclose(
        sg.nll(torch.from_numpy(mu), torch.from_numpy(x)).numpy(),
        np.asarray(jsg.nll(jnp.asarray(mu), jnp.asarray(x))), rtol=1e-6)

    n = 20000
    z = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    s = sg.sample(torch.Generator().manual_seed(1), z)
    np.testing.assert_allclose(torch.linalg.norm(s, dim=-1).numpy(), 1.0, atol=1e-5)
    w = s[:, 2].double()
    mean_w = 1.0 / math.tanh(kappa) - 1.0 / kappa  # E[cos] of the vMF on S²
    assert abs(float(w.mean()) - mean_w) < 4 * float(w.std()) / math.sqrt(n)
    assert abs(float(s[:, 0].mean())) < 4 * float(s[:, 0].std()) / math.sqrt(n)


# --------------------------------------------------------------------------
# debug and timing
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Leaves:
    a: torch.Tensor
    b: list


def test_check_finite_matches_jax_on_nested_trees():
    good = np.ones((2, 3), np.float32)
    bad = good.copy()
    bad[1, 2] = np.nan
    ints = np.arange(4)
    for arrays, ok in (((good, good, ints), True), ((good, bad, ints), False),
                       ((good, ints, bad * np.inf), False)):
        a, b, c = arrays
        tree_t = {"x": torch.from_numpy(a), "y": [_Leaves(torch.from_numpy(b), [c])]}
        tree_j = {"x": jnp.asarray(a), "y": [(jnp.asarray(b), [c])]}
        assert TDBG.check_finite(tree_t, raise_on_fail=False) is ok
        assert JDBG.check_finite(tree_j, raise_on_fail=False) is ok
        if not ok:
            with pytest.raises(FloatingPointError, match="leaves"):
                TDBG.check_finite(tree_t, name="t")


def test_snapshot_on_error_dumps_tensor_arguments(tmp_path, capsys):
    path = str(tmp_path / "snap.npz")

    def boom(x, y, scale=2.0, mask=None):
        raise ValueError("boom")

    x = torch.arange(6.0).reshape(2, 3)
    mask = np.array([True, False])
    with pytest.raises(ValueError, match="boom"):
        TDBG.snapshot_on_error(boom, path)(x, [x * 2], scale=3.0, mask=mask)
    with np.load(path) as z:
        assert sorted(z.files) == ["arg_0", "arg_1", "arg_3"]
        np.testing.assert_array_equal(z["arg_1"], (x * 2).numpy())
        np.testing.assert_array_equal(z["arg_3"], mask)
    assert path in capsys.readouterr().out
    assert TDBG.snapshot_on_error(lambda v: v + 1, path)(1) == 2


def test_trace_writes_a_chrome_trace_and_timed_waits(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with TDBG.trace(log_dir) as d:
        med, times, out = TT.timed(torch.matmul, x, x, warmup=1, iters=3)
    assert d == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    assert len(times) == 3 and med == float(np.median(times)) and med > 0
    assert torch.equal(out, x @ x)


def _debug_scene(nan: bool):
    rng = np.random.RandomState(11)
    n, c = 300, 3
    means = (rng.randn(n, 3) * 0.3 + [0, 0, 2.5]).astype(np.float32)
    if nan:
        means[17, 0] = np.nan
    arrays = dict(means=means, scales=(rng.rand(n, 3) * 0.05 + 0.01).astype(np.float32),
                  rots=rng.randn(n, 4).astype(np.float32),
                  op=rng.rand(n).astype(np.float32),
                  feats=rng.rand(n, c).astype(np.float32))
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    common = dict(image_height=32, image_width=32, tanfovx=1.0, tanfovy=1.0,
                  scale_modifier=1.0, sh_degree=0)
    js = JR.GaussianRasterizationSettings(
        bg=jnp.full((c,), 0.5), viewmatrix=jnp.eye(4), projmatrix=jnp.asarray(P.T),
        campos=jnp.zeros(3), debug=True, **common)
    ts = TR.GaussianRasterizationSettings(
        bg=torch.full((c,), 0.5), viewmatrix=torch.eye(4),
        projmatrix=torch.from_numpy(P.T.copy()), campos=torch.zeros(3),
        debug=True, **common)
    return arrays, js, ts


def _torch_render(a, ts, route):
    kw = dict(scales=torch.from_numpy(a["scales"]), rotations=torch.from_numpy(a["rots"]),
              colors_precomp=torch.from_numpy(a["feats"]))
    means, op = torch.from_numpy(a["means"]), torch.from_numpy(a["op"])
    if route == "aligned":
        from gpcr_tpu_torch.ops.rasterize_aligned import rasterize_gaussians_aligned

        return rasterize_gaussians_aligned(means, op, ts, config=TR.RasterizeConfig(
            chunk_size=64), **kw)[0]
    cfg = TR.RasterizeConfig(differentiable=route == "differentiable", chunk_size=64)
    return TR.rasterize_gaussians(means, op, ts, config=cfg, **kw)[0]


@pytest.mark.parametrize("route", ["stream", "differentiable", "aligned"])
def test_rasterize_debug_flag_raises_on_non_finite_mean(route):
    """settings.debug: a NaN mean raises FloatingPointError in both
    packages (JAX on its CPU route); without it, debug on and off render
    the same image."""
    a, js, ts = _debug_scene(nan=True)
    with pytest.raises(FloatingPointError, match="rasterize"):
        JR.rasterize_gaussians(
            jnp.asarray(a["means"]), jnp.asarray(a["op"]), js,
            scales=jnp.asarray(a["scales"]), rotations=jnp.asarray(a["rots"]),
            colors_precomp=jnp.asarray(a["feats"]))
    with pytest.raises(FloatingPointError, match="rasterize"):
        _torch_render(a, ts, route)
    a, _, ts = _debug_scene(nan=False)
    on = _torch_render(a, ts, route)
    off = _torch_render(a, ts._replace(debug=False), route)
    assert torch.equal(on, off) and bool(torch.isfinite(on).all())


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("flip", [False, True])
def test_convert_torch_state_dict_flip_kernel_axes_matches_jax(flip):
    rng = np.random.RandomState(9)
    state = {"enc.conv0.kernel": torch.from_numpy(rng.randn(27, 3, 4).astype(np.float32)),
             "enc.lin.kernel": torch.from_numpy(rng.randn(3, 4).astype(np.float32)),
             "enc.conv0.bias": torch.from_numpy(rng.randn(4).astype(np.float32)),
             "head.default_quaternion": torch.ones(4)}
    want = JCK._flatten(JCK.convert_torch_state_dict(state, flip_kernel_axes=flip))
    got = TCK._flatten(TCK.convert_torch_state_dict(state, flip_kernel_axes=flip))
    assert sorted(got) == sorted(want) == ["enc.conv0.bias", "enc.conv0.kernel",
                                           "enc.lin.kernel"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    k0 = state["enc.conv0.kernel"].numpy()
    np.testing.assert_array_equal(got["enc.conv0.kernel"], k0[::-1] if flip else k0)


def test_convert_torch_lpips_matches_jax():
    from gpcr_tpu.metrics import lpips as JLP

    rng = np.random.RandomState(10)
    module = torch.nn.Module()
    sd = {}
    for i, li in enumerate([0, 3, 6, 8, 10]):
        sd[f"net.slice{i + 1}.{li}.weight"] = rng.randn(4, 3, 3, 3)
        sd[f"net.slice{i + 1}.{li}.bias"] = rng.randn(4)
        sd[f"lins.{i}.model.1.weight"] = rng.rand(1, 4, 1, 1)
    for name, v in sd.items():
        module.register_buffer(name.replace(".", "_"), torch.from_numpy(v.astype(np.float32)))
    module.state_dict = lambda: {k: getattr(module, k.replace(".", "_")) for k in sd}
    want = JLP.convert_torch_lpips(module)
    got = TLP.convert_torch_lpips(module)
    assert sorted(got) == sorted(want) and len(got) == 15
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

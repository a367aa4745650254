"""Port parity of the training rasterizer: ``gpcr_tpu_torch``'s
differentiable stream path (plain versions of the contributor-count
forward and the replay backward, on the CPU) against ``gpcr_tpu``'s
``rasterize_gaussians_stream_diff`` with its Pallas kernels in interpret
mode, as tests/test_stream_vjp.py runs them.

Tolerances are that file's: image rtol/atol 2e-4; gradients rtol 5e-3 with
atol 5e-4 * max|g| (the two backwards rebuild each transmittance by
dividing in another order); bg / final-T gradients rtol 5e-3, atol 1e-4.
The contributor count is compared exactly after ``min(n_jax, e - s)``: the
JAX kernel also counts the padding rows of a tile's last chunk for a pixel
that never terminates, the port reports the length of the range, and the
backward masks positions at or past ``e`` either way.

The CUDA kernels themselves are checked against the plain versions on the
card by tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.ops import rasterize_stream_vjp as JV
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.ops import rasterize_stream_vjp as TV
from gpcr_tpu_torch.render.renderer import pin_fp32

from test_rasterize import make_camera_matrices, random_scene
from torch_streams import tile_stream

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()

BG = np.array([0.15, 0.25, 0.35], np.float32)


def _settings(W, H, bg):
    view_t, full_t, tanfov, campos = make_camera_matrices(
        [0.0, 0.0, -2.5], W, H)
    js = JR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=tanfov, tanfovy=tanfov,
        bg=jnp.asarray(bg), scale_modifier=1.0, viewmatrix=view_t,
        projmatrix=full_t, sh_degree=0, campos=campos)
    ts = TR.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=tanfov, tanfovy=tanfov,
        bg=torch.from_numpy(np.asarray(bg)), scale_modifier=1.0,
        viewmatrix=torch.from_numpy(np.array(view_t)),
        projmatrix=torch.from_numpy(np.array(full_t)), sh_degree=0,
        campos=torch.from_numpy(np.array(campos)))
    return js, ts


def _configs(**kw):
    kw = dict(tile_x=16, tile_y=16, max_dup_per_gaussian=9, chunk_size=8,
              differentiable=True, **kw)
    return JR.RasterizeConfig(max_chunks=64, **kw), TR.RasterizeConfig(**kw)


def _weights(shape):
    """Non-uniform weighting so dL/dout varies per pixel and channel."""
    size = int(np.prod(shape))
    return 0.5 + (np.arange(size).reshape(shape) % 7).astype(np.float32) / 7.0


def _jax_grads(scene, js, jcfg, w):
    def loss(m, s, q, o, f):
        color, _ = JV.rasterize_gaussians_stream_diff(
            m, o, js, scales=s, rotations=q, colors_precomp=f, config=jcfg,
            interpret=True)
        return jnp.sum(color * w), color

    # jitted: the interpret-mode kernels then run compiled, not op by op
    (_, color), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *[jnp.asarray(x) for x in scene])
    return np.asarray(color), [np.asarray(g) for g in grads]


def _torch_grads(scene, ts, tcfg, w):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in scene]
    m, s, q, o, f = leaves
    before = (TRS.LAUNCHES_CONTRIB, TV.LAUNCHES_BWD)
    color, _ = TR.rasterize_gaussians(
        m, o, ts, scales=s, rotations=q, colors_precomp=f, config=tcfg)
    torch.sum(color * torch.from_numpy(w)).backward()
    # CPU tensors never reach the kernels
    assert (TRS.LAUNCHES_CONTRIB, TV.LAUNCHES_BWD) == before
    return color.detach().numpy(), [x.grad.numpy() for x in leaves]


def _assert_grads_close(got, want):
    for nm, a, b in zip(["means", "scales", "rots", "ops", "feats"], want, got):
        scale = max(1e-3, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"grad mismatch for {nm}")


@pytest.mark.parametrize("n,wh,seed", [(60, 32, 1), (150, 48, 2)])
def test_image_and_gradients_match_jax_vjp(n, wh, seed):
    scene = random_scene(n, seed=seed)
    js, ts = _settings(wh, wh, BG)
    jcfg, tcfg = _configs()
    w = _weights((3, wh, wh))
    j_color, j_grads = _jax_grads(scene, js, jcfg._replace(tiles_per_step=2), w)
    t_color, t_grads = _torch_grads(scene, ts, tcfg, w)
    np.testing.assert_allclose(t_color, j_color, rtol=2e-4, atol=2e-4)
    _assert_grads_close(t_grads, j_grads)


def test_max_active_tiles_below_tile_count():
    """Two of the four tiles render; the entries of the rest count as
    overflow and their pixels keep the background in both packages."""
    scene = random_scene(60, seed=3)
    js, ts = _settings(32, 32, BG)
    jcfg, tcfg = _configs(max_active_tiles=2)
    w = _weights((3, 32, 32))
    j_color, j_grads = _jax_grads(scene, js, jcfg._replace(tiles_per_step=2), w)
    t_color, t_grads = _torch_grads(scene, ts, tcfg, w)
    np.testing.assert_allclose(t_color, j_color, rtol=2e-4, atol=2e-4)
    _assert_grads_close(t_grads, j_grads)
    _, _, extra = TR.rasterize_gaussians(
        torch.from_numpy(scene[0]), torch.from_numpy(scene[3]), ts,
        scales=torch.from_numpy(scene[1]), rotations=torch.from_numpy(scene[2]),
        colors_precomp=torch.from_numpy(scene[4]), config=tcfg,
        return_extra=True)
    assert int(extra["dup_overflow"]) > 0


def test_background_and_final_t_gradient():
    """bg gradient and a loss through final_T (tests/test_stream_vjp.py)."""
    means, scales, rots, ops, feats = random_scene(40, seed=5)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    js, ts = _settings(32, 32, bg)
    jcfg, tcfg = _configs()

    def loss_j(bgv, o):
        c, _, extra = JV.rasterize_gaussians_stream_diff(
            jnp.asarray(means), o, js._replace(bg=bgv),
            scales=jnp.asarray(scales), rotations=jnp.asarray(rots),
            colors_precomp=jnp.asarray(feats),
            config=jcfg._replace(tiles_per_step=1), interpret=True,
            return_extra=True)
        return jnp.sum(c * 0.7) + jnp.sum(extra["final_T"] * 0.3)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(bg), jnp.asarray(ops))

    bgv = torch.from_numpy(bg.copy()).requires_grad_(True)
    o = torch.from_numpy(ops.copy()).requires_grad_(True)
    c, _, extra = TR.rasterize_gaussians(
        torch.from_numpy(means), o, ts._replace(bg=bgv),
        scales=torch.from_numpy(scales), rotations=torch.from_numpy(rots),
        colors_precomp=torch.from_numpy(feats), config=tcfg, return_extra=True)
    assert not extra["dup_overflow"].requires_grad
    (torch.sum(c * 0.7) + torch.sum(extra["final_T"] * 0.3)).backward()
    for nm, a, b in zip(["bg", "opacity"], want, [bgv.grad, o.grad]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-3,
                                   atol=1e-4, err_msg=f"grad mismatch for {nm}")


def test_clamped_alpha_has_exactly_zero_opacity_gradient():
    """A gaussian whose op * exp(power) >= 0.99 at the one pixel the loss
    reads gets no gradient to its opacity (``minimum`` semantics), exactly,
    in both packages; its neighbours behind it still do."""
    means, scales, rots, ops, feats = random_scene(30, seed=7)
    # gaussian 0: in front of everything, ~3 px wide, far above the clamp
    means[0] = [0.0, 0.0, -1.0]
    scales[0] = 0.05
    ops[0] = 5.0
    scene = (means, scales, rots, ops, feats)
    js, ts = _settings(32, 32, BG)
    jcfg, tcfg = _configs()
    prep = TR.preprocess(torch.from_numpy(means), torch.from_numpy(ops), ts,
                         tcfg, scales=torch.from_numpy(scales),
                         rotations=torch.from_numpy(rots),
                         colors_precomp=torch.from_numpy(feats))
    x, y = [int(round(float(v))) for v in prep.mean2d[0]]
    w = np.zeros((3, 32, 32), np.float32)
    w[:, y, x] = 1.0
    _, j_grads = _jax_grads(scene, js, jcfg._replace(tiles_per_step=1), w)
    _, t_grads = _torch_grads(scene, ts, tcfg, w)
    assert j_grads[3][0] == 0.0 and t_grads[3][0] == 0.0
    assert np.abs(t_grads[3][1:]).max() > 0
    _assert_grads_close(t_grads, j_grads)


def _jax_forward_state(scene, js, jcfg):
    """The JAX forward's residuals on a scene: its stream, starts, final T
    and contributor count (``_fwd_impl`` through the Pallas kernel)."""
    means, scales, rots, ops, feats = [jnp.asarray(x) for x in scene]
    prep = JR.preprocess(means, ops, js, jcfg, scales=scales, rotations=rots,
                         colors_precomp=feats)
    diff = dict(mean2d=prep.mean2d, conic=prep.conic, opacity=prep.opacity,
                features=prep.features, bg=js.bg)
    aux = dict(depth=prep.depth, rect_f=prep.rect.astype(jnp.float32),
               valid_f=prep.valid.astype(jnp.float32))
    grid_x = -(-js.image_width // 16)
    num_tiles = grid_x * -(-js.image_height // 16)
    res = jax.jit(lambda d, a: JV._fwd_impl(
        num_tiles, grid_x, jcfg, 3, True, d, a)[3])(diff, aux)
    return res, num_tiles, grid_x


def _jax_bwd_rows(res, dl_dout, dt_tot, num_tiles, grid_x, jcfg, channels):
    """Per-entry gradient rows as ``_bwd_kernel`` writes them (the launch
    of ``_blend_core_bwd``, without its epilogue)."""
    p, ch, tps = 256, jcfg.chunk_size, 1
    stream, starts = res["stream"], res["starts"]
    kbp, ncols = stream.shape
    order_b = jnp.sort(res["order_g"][:num_tiles])
    cpad = -(-(channels + 3) // 8) * 8
    dout_t = jnp.concatenate([
        jnp.asarray(dl_dout).transpose(0, 2, 1), res["n_contrib"][:, None, :],
        jnp.asarray(dt_tot)[:, None, :], res["t_run"][:, None, :],
        jnp.zeros((num_tiles, cpad - channels - 3, p), jnp.float32)], axis=1)
    dout_b = jnp.concatenate(
        [dout_t, jnp.zeros((1, cpad, p), jnp.float32)], axis=0)[order_b]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(num_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((tps, cpad, p), lambda i, *_: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.VMEM((2, ch, ncols), jnp.float32),
                        pltpu.VMEM((ch, ncols), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA(())])
    kernel = functools.partial(
        JV._bwd_kernel, grid_x=grid_x, tile_x=16, tile_y=16, chunk=ch,
        ncols=ncols, channels=channels, tps=tps)
    return jax.jit(pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((kbp, ncols), jnp.float32),
        interpret=True,
    ))(order_b, jnp.concatenate([starts, starts[-1:]]), stream, dout_b)


@pytest.mark.parametrize("n,wh,seed", [(60, 32, 1), (150, 48, 2)])
def test_contributor_count_and_entry_rows_match_jax_kernels(n, wh, seed):
    """On the JAX forward's own stream: the plain forward's n_contrib
    equals min(n_jax, e - s), and ``blend_tiles_bwd_plain`` writes the rows
    ``_bwd_kernel`` writes (rows of rendered tiles below each tile's
    contributor ceiling; the JAX kernel leaves the rest uninitialised)."""
    scene = random_scene(n, seed=seed)
    js, _ = _settings(wh, wh, BG)
    jcfg, tcfg = _configs()
    jcfg = jcfg._replace(tiles_per_step=1)
    res, num_tiles, grid_x = _jax_forward_state(scene, js, jcfg)
    starts = torch.from_numpy(np.asarray(res["starts"]).astype(np.int32))
    total = int(starts[-1])
    stream = torch.from_numpy(np.array(res["stream"])[:total, :11]).contiguous()
    order = torch.arange(num_tiles, dtype=torch.int32)

    acc, t_run, cnt = TRS.blend_tiles(stream, starts, order, num_tiles, grid_x,
                                      3, tcfg, with_contrib=True)
    assert cnt.dtype == torch.int32
    counts = (starts[1:] - starts[:-1]).numpy()
    j_cnt = np.asarray(res["n_contrib"]).astype(np.int64)
    np.testing.assert_array_equal(
        cnt.numpy(), np.minimum(j_cnt, counts[:, None]))
    np.testing.assert_allclose(t_run.numpy(), np.asarray(res["t_run"]),
                               atol=1e-5)

    rng = np.random.RandomState(seed)
    dl_dout = rng.randn(num_tiles, 256, 3).astype(np.float32)
    dt_tot = rng.randn(num_tiles, 256).astype(np.float32)
    rows = TV.blend_tiles_bwd(
        stream, starts, order, torch.from_numpy(dl_dout), cnt,
        torch.from_numpy(dt_tot), t_run, grid_x, 3, tcfg).numpy()
    j_rows = np.asarray(_jax_bwd_rows(res, dl_dout, dt_tot, num_tiles, grid_x,
                                      jcfg, 3))[:total, :11]
    # rows the JAX kernel wrote: in-tile position below the chunk-granular
    # contributor ceiling; past the exact ceiling both are zero rows
    s = starts[:-1].numpy()
    tile_of = np.repeat(np.arange(num_tiles), counts)
    pos = np.arange(total) - s[tile_of]
    ceil_j = -(-j_cnt.max(axis=1) // jcfg.chunk_size) * jcfg.chunk_size
    written = pos < ceil_j[tile_of]
    assert written.sum() > 0.5 * total
    scale = np.abs(j_rows[written]).max(axis=0)
    np.testing.assert_allclose(rows[written], j_rows[written], rtol=5e-3,
                               atol=5e-4 * scale.max())
    assert not rows[~written].any()
    assert np.abs(rows[:, [0, 1, 2, 3, 4, 5, 8, 9, 10]]).max(axis=0).min() > 0
    assert not rows[:, 6:8].any()


def test_live_pair_count_matches_a_sequential_walk():
    """``with_live`` counts, per pixel, the walked positions that were
    composited; held against a walk of each tile entry by entry (the CUDA
    kernel's loop, in numpy float32)."""
    scene = random_scene(150, seed=2)
    js, _ = _settings(48, 48, BG)
    jcfg, tcfg = _configs()
    res, num_tiles, grid_x = _jax_forward_state(
        scene, js, jcfg._replace(tiles_per_step=1))
    starts = torch.from_numpy(np.asarray(res["starts"]).astype(np.int32))
    total = int(starts[-1])
    stream = torch.from_numpy(np.array(res["stream"])[:total, :11]).contiguous()
    order = torch.arange(num_tiles, dtype=torch.int32)
    _, _, cnt, live = TRS.blend_tiles_plain(
        stream, starts, order, num_tiles, grid_x, 3, tcfg, with_contrib=True,
        with_live=True)
    with pytest.raises(ValueError, match="with_live"):
        TRS.blend_tiles_plain(stream, starts, order, num_tiles, grid_x, 3,
                              tcfg, with_live=True)

    rows = stream.numpy()
    f32 = np.float32
    want_cnt = np.zeros((num_tiles, 256), np.int32)
    want_live = np.zeros((num_tiles, 256), np.int32)
    for tile in range(num_tiles):
        s, e = int(starts[tile]), int(starts[tile + 1])
        px = f32((tile % grid_x) * 16) + (np.arange(256) % 16).astype(f32)
        py = f32((tile // grid_x) * 16) + (np.arange(256) // 16).astype(f32)
        T = np.ones(256, f32)
        done = np.zeros(256, bool)
        want_cnt[tile] = e - s
        for j in range(s, e):
            r = rows[j]
            dx, dy = r[0] - px, r[1] - py
            power = f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            alpha = np.minimum(f32(0.99), r[5] * np.exp(power))
            skip = (power > 0) | (alpha < f32(1.0 / 255.0))
            test_T = T * (f32(1.0) - alpha)
            stops = ~done & ~skip & (test_T < f32(1e-4))
            want_cnt[tile][stops] = j - s
            done |= stops
            comp = ~done & ~skip
            want_live[tile] += comp
            T = np.where(comp, test_T, T)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(live.numpy(), want_live)
    assert 0 < int(live.sum()) < int(cnt.sum())


# --------------------------------------------------------------------------
# the replay-backward kernel's segment decomposition
# --------------------------------------------------------------------------


def _segmented_bwd(stream, starts, order, dl_dout, n_contrib, dt_tot,
                   t_final, grid_x, channels, seg_len):
    """The replay backward as ``csrc/stream_blend_bwd.cu`` computes it, in
    float32: ``segment_plan``'s segments; per segment and pixel P_k (the
    product of 1 - a) and S_k (the sum of a * t * G) in a front-to-back
    pass; T_end(k) and B_end(k) by a scan over the tile's segments; then
    each segment walked back to front from (T_end, B_end), entry by
    entry."""
    plan, bound = TV.segment_plan(starts, order, n_contrib, seg_len,
                                  stream.shape[0])
    assert int(plan[0, -1]) <= bound
    grads = torch.zeros_like(stream)
    pix = torch.arange(256)
    lx, ly = (pix % 16).to(torch.float32), (pix // 16).to(torch.float32)
    c0 = TRS.STREAM_FEAT_COL
    for g, tile in enumerate(order.tolist()):
        lim = int(plan[1, g])
        nseg = int(plan[0, g]) - (int(plan[0, g - 1]) if g else 0)
        assert nseg == -(-lim // seg_len)
        if lim == 0:
            continue
        s = int(starts[tile])
        rows = stream[s:s + lim]
        dx = rows[:, 0:1] - (float(tile % grid_x * 16) + lx)[None]
        dy = rows[:, 1:2] - (float(tile // grid_x * 16) + ly)[None]
        power = (-0.5 * (rows[:, 2:3] * dx * dx + rows[:, 4:5] * dy * dy)
                 - rows[:, 3:4] * dx * dy)
        gauss = torch.exp(power)
        raw = rows[:, 5:6] * gauss
        alpha = torch.clamp(raw, max=0.99)
        live = (~(power > 0.0) & ~(alpha < 1.0 / 255.0)
                & (torch.arange(lim)[:, None] < n_contrib[tile][None].long()))
        a = torch.where(live, alpha, torch.zeros_like(alpha))
        dL = dl_dout[tile]
        G = rows[:, c0:c0 + channels] @ dL.T  # (lim, 256)
        segs = [range(k * seg_len, min((k + 1) * seg_len, lim))
                for k in range(nseg)]
        P, S = [], []
        for seg in segs:
            t, sk = torch.ones(256), torch.zeros(256)
            for i in seg:
                sk = torch.where(live[i], sk + a[i] * t * G[i], sk)
                t = torch.where(live[i], t * (1.0 - a[i]), t)
            P.append(t)
            S.append(sk)
        T_end, T = [], torch.ones(256)
        for p in P:
            T = T * p
            T_end.append(T)
        B_end, B = [None] * nseg, t_final[tile] * dt_tot[tile]
        for k in range(nseg - 1, -1, -1):
            B_end[k] = B
            B = B + (T_end[k - 1] if k else 1.0) * S[k]
        for k, seg in enumerate(segs):
            T_after, B = T_end[k], B_end[k]
            for i in reversed(seg):
                r_om = 1.0 / (1.0 - a[i])
                T_excl = T_after * r_om
                w = a[i] * T_excl
                dL_da = T_excl * G[i] - B * r_om
                free = live[i] & (raw[i] < 0.99)
                zero = torch.zeros(256)
                dpow = torch.where(free, dL_da * a[i], zero)
                r = rows[i]
                grads[s + i, 0] = torch.sum(
                    -dpow * (r[2] * dx[i] + r[3] * dy[i]))
                grads[s + i, 1] = torch.sum(
                    -dpow * (r[4] * dy[i] + r[3] * dx[i]))
                grads[s + i, 2] = torch.sum(-0.5 * dpow * dx[i] * dx[i])
                grads[s + i, 3] = torch.sum(-dpow * dx[i] * dy[i])
                grads[s + i, 4] = torch.sum(-0.5 * dpow * dy[i] * dy[i])
                grads[s + i, 5] = torch.sum(torch.where(free, dL_da * gauss[i],
                                                        zero))
                grads[s + i, c0:c0 + channels] = (
                    torch.where(live[i], w, zero)[:, None] * dL).sum(0)
                B = torch.where(live[i], B + w * G[i], B)
                T_after = torch.where(live[i], T_excl, T_after)
    return grads


@pytest.mark.parametrize("seg_len", [7, 16])
def test_segmented_backward_matches_plain(seg_len):
    """Segments of 7 and 16 entries that do not divide the tile ranges;
    tiles of 0, 1, L and L + 1 entries and longer ones; pixels that stop
    in the first segment and pixels forced to n_contrib = 0; against
    ``blend_tiles_bwd_plain`` at the replay kernel's limits (per column
    1e-4 * max|plain| + 1e-6, in L2 1e-5 * ||plain|| + 1e-6)."""
    counts = [0, 1, seg_len, seg_len + 1, 3 * seg_len + 2, 5 * seg_len - 1]
    channels, grid_x, nt = 3, 3, len(counts)
    stream, starts = tile_stream(counts, seed=seg_len, channels=channels)
    tcfg = TR.RasterizeConfig(chunk_size=8, differentiable=True)
    order = torch.argsort(-(starts[1:] - starts[:-1]), stable=True).to(
        torch.int32)
    _, t_run, cnt = TRS.blend_tiles_plain(stream, starts, order, nt, grid_x,
                                          channels, tcfg, with_contrib=True)
    counts_t = (starts[1:] - starts[:-1])[:, None]
    assert bool(((cnt > 0) & (cnt < seg_len)).any())  # stop in segment 0
    assert bool((cnt == counts_t).any())  # and some never stop
    cnt = cnt.clone()
    cnt[4, ::7] = 0
    rng = np.random.RandomState(seg_len)
    dl_dout = torch.from_numpy(rng.randn(nt, 256, channels).astype(np.float32))
    dt_tot = torch.from_numpy(rng.randn(nt, 256).astype(np.float32))
    args = (stream, starts, order, dl_dout, cnt, dt_tot, t_run, grid_x,
            channels)
    got = _segmented_bwd(*args, seg_len)
    want = TV.blend_tiles_bwd_plain(*args, tcfg)
    col_err = (got - want).abs().amax(dim=0)
    assert bool((col_err <= 1e-4 * want.abs().amax(dim=0) + 1e-6).all()), (
        col_err, want.abs().amax(dim=0))
    l2 = torch.linalg.vector_norm((got - want).double(), dim=0)
    assert bool((l2 <= 1e-5 * torch.linalg.vector_norm(want.double(), dim=0)
                 + 1e-6).all())
    used = [0, 1, 2, 3, 4, 5, 8, 9, 10]
    assert float(want[:, used].abs().amax(dim=0).min()) > 0
    plan, _ = TV.segment_plan(starts, order, cnt, seg_len, stream.shape[0])
    assert plan.dtype == torch.int32 and plan.shape == (2, nt)

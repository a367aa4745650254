"""Port parity of training: losses, the optimizer and ``Trainer.loss_fn``
of ``gpcr_tpu_torch`` against ``gpcr_tpu`` on the CPU.

Tolerances: losses 1e-6; optimizer parameters 1e-6 after each of 6 updates
(the same float32 arithmetic in another order); the loss value rtol 1e-4
and every parameter gradient rtol 5e-3 with atol 5e-4 * max|g| of its leaf
(tests/test_stream_vjp.py's bar: JAX runs its XLA scan on the CPU, the
port its replay backward, which rebuilds each transmittance by division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.train import data as JD
from gpcr_tpu.train import losses as JL
from gpcr_tpu.train import trainer as JT
from gpcr_tpu_torch.ops import sparse
from gpcr_tpu_torch.render.checkpoint import grads_to_jax_tree, load_jax_params
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.train import data as TD
from gpcr_tpu_torch.train import losses as TL
from gpcr_tpu_torch.train import trainer as TT

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

pin_fp32()

INFO = {
    "clr_encoder_channels": "9 8 8 8 8 8", "sh_deg": 1, "sh_feat_deg": 0,
    "use_rotation": True, "use_scale": True, "use_offset": True,
    "use_dc_offset": False, "use_opacity": False, "est_normal": True,
    "normalize_normal": True, "enable_opacity": True, "scale_factor": 96,
    "model_type": "unet",
}


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _loss_inputs():
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 6, 6, 3).astype(np.float32) * 1.2 - 0.1
    gt = rng.rand(2, 6, 6, 3).astype(np.float32)
    mask = (rng.rand(2, 6, 6, 1) > 0.4).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize("name,masked", [("l1", False), ("l1", True),
                                         ("l2", False), ("l2", True)])
def test_l1_l2_match_jax(name, masked):
    pred, gt, mask = _loss_inputs()
    m = mask if masked else None
    want = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(gt),
                             None if m is None else jnp.asarray(m))
    got = getattr(TL, name)(_t(pred), _t(gt), None if m is None else _t(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_focal_bce_and_render_losses_match_jax():
    pred, gt, mask = _loss_inputs()
    want = JL.focal_bce(jnp.asarray(pred[..., :1]), jnp.asarray(mask))
    got = TL.focal_bce(_t(pred[..., :1]), _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)

    rng = np.random.RandomState(1)
    out = {"rgb": pred, "hitmap": rng.rand(2, 6, 6, 3).astype(np.float32),
           "normal": rng.randn(2, 6, 6, 3).astype(np.float32)}
    gts = {"rgb": gt, "normal_w": rng.randn(2, 6, 6, 3).astype(np.float32),
           "hit_map": mask[..., 0]}  # no channel axis: the loss adds it
    w_total, w_terms = JL.render_losses(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in gts.items()})
    g_total, g_terms = TL.render_losses(
        {k: _t(v) for k, v in out.items()}, {k: _t(v) for k, v in gts.items()})
    assert TL.LossWeights() == tuple(JL.LossWeights())
    assert sorted(g_terms) == sorted(w_terms) == ["hit", "normal", "rgb"]
    np.testing.assert_allclose(float(g_total), float(w_total), rtol=1e-6)
    for k in w_terms:
        np.testing.assert_allclose(float(g_terms[k]), float(w_terms[k]),
                                   rtol=1e-6, atol=1e-6)
    # without a predicted normal the term drops out of both
    out.pop("normal")
    w2, _ = JL.render_losses({k: jnp.asarray(v) for k, v in out.items()},
                             {k: jnp.asarray(v) for k, v in gts.items()})
    g2, _ = TL.render_losses({k: _t(v) for k, v in out.items()},
                             {k: _t(v) for k, v in gts.items()})
    np.testing.assert_allclose(float(g2), float(w2), rtol=1e-6)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------


def test_optimizer_matches_optax_chain():
    """Six updates with the same gradients: warmup over 4 updates, some
    gradients above the clip and some below. The first update has
    learning rate 0 and is a no-op in both."""
    import optax

    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
              for k, v in p0.items()}
             for s in (3.0, 0.05, 2.0, 0.01, 5.0, 0.1)]

    tx = JT.make_optimizer(learning_rate=1e-2, num_warmup_steps=4, clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    opt = TT.make_optimizer(tp.values(), learning_rate=1e-2,
                            num_warmup_steps=4, clip=1.0)
    assert [opt.lr_at(c) for c in (0, 2, 4, 9)] == [0.0, 5e-3, 1e-2, 1e-2]
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k in tp:
            tp[k].grad = _t(g[k].copy())
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"update {i}, {k}")
        if i == 0:
            for k in tp:
                np.testing.assert_array_equal(tp[k].detach().numpy(), p0[k])
    assert opt.count == 6
    assert max(float(np.abs(tp[k].detach().numpy() - p0[k]).max())
               for k in tp) > 1e-3

    # state survives a save / load round trip
    tp2 = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    opt2 = TT.make_optimizer(tp2.values(), 1e-2, 4, 1.0)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 6


# --------------------------------------------------------------------------
# Trainer.loss_fn: value and every parameter gradient
# --------------------------------------------------------------------------


def _torch_batch(jbatch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()
           if k != "tanfov"}
    out["tanfov"] = float(jbatch["tanfov"])
    return out


def test_loss_fn_value_and_gradients_match_jax():
    """``scale_factor`` 8 makes the cloud dense on its grid. The JAX
    trainer gives the U-Net's coarse levels static capacities n/2 and n/4
    and drops the voxels beyond them, which a cloud as sparse as the other
    tests' 128 points at scale 96 overflows (the port holds exactly the
    voxels of each level); the test checks that this cloud fits."""
    hw, n = 16, 128
    info = dict(INFO, scale_factor=8)
    jtr = JT.Trainer(info=info, render_hw=(hw, hw))
    params, _ = jtr.init(jax.random.PRNGKey(0))
    # the initial biases are zero, which puts many pre-activations at exactly
    # 0, where the two frameworks' relu subgradients differ (0.5 and 0):
    # carry weights with small random biases instead
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + jnp.asarray(
            0.05 * rng.randn(*x.shape).astype(np.float32))
            if path[-1].key == "bias" else x), params)
    jbatch = JD.DataLoader(batch_size=1, n_points=n, n_views=1, hw=hw,
                           scale_factor=8, seed=3,
                           synthetic_pool=1).next_batch()
    (want, want_terms), want_grads = jax.jit(
        jax.value_and_grad(jtr.loss_fn, has_aux=True))(params, jbatch)

    ttr = TT.Trainer(info=info, render_hw=(hw, hw), device="cpu")
    load_jax_params(ttr.model, jax.tree_util.tree_map(np.asarray, params))
    tbatch = _torch_batch(jbatch)
    grid = sparse.quantize_average(
        tbatch["coords"][0], tbatch["rgb"][0], valid=tbatch["valid"][0])
    levels = [g.num for g in ttr.model.build_plan(grid)["grids"]]
    assert levels[2] <= n // 2 and levels[3] <= n // 4, levels
    got, got_terms = ttr.loss_fn(tbatch)
    got.backward()
    assert int(ttr.last_dup_overflow) == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for k in want_terms:
        np.testing.assert_allclose(float(got_terms[k].detach()), float(want_terms[k]),
                                   rtol=1e-4, atol=1e-7)

    got_grads = grads_to_jax_tree(ttr.model)
    want_leaves, treedef = jax.tree_util.tree_flatten(want_grads)
    got_leaves = treedef.flatten_up_to(got_grads)
    assert len(want_leaves) > 20
    moved = 0
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(want_grads)[0], got_leaves):
        a = np.asarray(a)
        scale = float(np.abs(a).max())
        moved += scale > 0
        np.testing.assert_allclose(
            b, a, rtol=5e-3, atol=5e-4 * max(scale, 1e-6),
            err_msg=jax.tree_util.keystr(path))
    assert moved > 20  # the gradients really reach the network


# --------------------------------------------------------------------------
# training behaviour (mirrors of tests/test_multichip.py)
# --------------------------------------------------------------------------


def test_grads_finite_with_padding_rows():
    """A batch whose clouds have padding rows (valid=False) must give
    finite gradients (d|n|/dn at zero rows once poisoned the last conv's
    gradients through normalize_normal)."""
    info = dict(INFO, use_dc_offset=True, use_opacity=True)
    trainer = TT.Trainer(info=info, render_hw=(24, 24), device="cpu",
                         learning_rate=1e-3, num_warmup_steps=10)
    batch = TD.DataLoader(batch_size=1, n_points=512, n_views=1, hw=24, seed=0,
                          synthetic_pool=1, device="cpu").next_batch()
    assert not bool(batch["valid"].all()), "fixture must include padding"
    total, _ = trainer.loss_fn(batch)
    total.backward()
    grads = [p.grad for p in trainer.model.parameters()]
    assert all(g is not None for g in grads)
    bad = sum(int((~torch.isfinite(g)).sum()) for g in grads)
    assert bad == 0, f"{bad} non-finite gradient elements"


def test_train_steps_decrease_loss():
    """Ten steps on one tiny scene reduce the loss. The target is the
    render of a differently seeded model, so it is reachable."""
    hw = 16
    trainer = TT.Trainer(info=INFO, render_hw=(hw, hw), device="cpu",
                         learning_rate=3e-3, num_warmup_steps=1)
    batch = TD.DataLoader(batch_size=1, n_points=128, n_views=1, hw=hw, seed=1,
                          synthetic_pool=1, device="cpu").next_batch()
    target = TT.Trainer(info=INFO, render_hw=(hw, hw), device="cpu",
                        generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        tgt = target._per_cloud_render(
            batch["coords"][0], batch["rgb"][0], batch["valid"][0],
            batch["view_t"][0], batch["full_t"][0], batch["campos"][0],
            batch["tanfov"])
    batch.update(gt_rgb=tgt["rgb"][None], gt_normal=tgt["normal"][None],
                 gt_hit=tgt["hitmap"][None, ..., :1])
    before = [p.detach().clone() for p in trainer.model.parameters()]
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(10)]
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1]  # the first update has learning rate 0
    assert np.mean(losses[-3:]) < losses[0], losses
    assert trainer.step_count == 10
    assert any(not torch.equal(a, b) for a, b in
               zip(before, trainer.model.parameters()))
    assert float(trainer.eval_psnr(batch)) > 0

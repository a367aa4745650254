"""The port's end-to-end forward entry (``gpcr_tpu_torch/entry.py``)
against ``__graft_entry__.py::entry``, on the CPU.

The JAX ``entry()`` plans its U-Net levels with capacities n, n, n/2, n/4
and drops the coarse voxels beyond them; the port holds every voxel of
each level (ROADMAP §3). The parity test therefore runs the real JAX
``entry()`` with ``PCEncoder`` swapped for a subclass whose plan lifts
every level's capacity to n; ``entry()`` imports ``PCEncoder`` inside its
body, so the swap takes effect. Its persistent compilation cache goes to
a temporary directory (``GPCR_JAX_CACHE``), and JAX's cache settings are
restored after the test. On the CPU the JAX ``fn`` renders through the
XLA exact path, not the Pallas kernel (ROADMAP §3).

Tolerances: the scene's ``coords`` and ``rgb`` bit for bit, its camera
within 1e-6; the image on all 12 channels at atol 1e-4
(tests/test_torch_render.py's bar for learned renders: the U-Net's
float32 sums run in another order).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from gpcr_tpu.models import encoder as JE
from gpcr_tpu.render import renderer as JRD
from gpcr_tpu_torch import entry as TE
from gpcr_tpu_torch.render import renderer as TRD

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)
TRD.pin_fp32()

CACHE_FLAGS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")
# the exact voxels per U-Net level of the entry's scene, and the JAX
# default capacities n, n, n/2, n/4 for its n = 256 points
LEVEL_VOXELS = [255, 252, 244, 195]
JAX_CAPS = [256, 256, 128, 64]


class _AllVoxels(JE.PCEncoder):
    """The JAX encoder with every U-Net level's capacity at the cloud's
    size, so that no coarse voxel is dropped."""

    def build_plan(self, grid, level_capacity=None, brick_capacity=None):
        n = grid.capacity
        return super().build_plan(grid, [n] * 4, brick_capacity)


def _recording(seen, render_one_view):
    """``render_one_view`` that also appends its dup-cap overflow to
    ``seen``."""
    def run(*args, **kwargs):
        color, overflow = render_one_view(*args, **kwargs)
        seen.append(overflow)
        return color, overflow
    return run


def test_tiny_scene_matches_jax():
    want = GE._tiny_scene()
    got = TE._tiny_scene(device="cpu")
    for name, w, g in zip(("coords", "rgb"), want[:2], got[:2]):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, w, g in zip(("view_t", "full_t", "campos"), want[2:5],
                          got[2:5]):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert abs(got[5] - float(want[5])) <= 1e-6


def test_entry_matches_jax_with_level_caps_lifted(monkeypatch, tmp_path):
    """The real JAX ``entry()`` (caps lifted, jitted once) against the
    port's ``fn`` with the JAX parameters carried across: all 12
    channels at 1e-4, and the same dup-cap overflow on both sides (0: the
    32² view has 4 tiles, below the cap of 8 per splat)."""
    monkeypatch.setenv("GPCR_JAX_CACHE", str(tmp_path / "jax_cache"))
    saved = {k: getattr(jax.config, k) for k in CACHE_FLAGS}
    monkeypatch.setattr(JE, "PCEncoder", _AllVoxels)
    seen_j, seen_t = [], []
    monkeypatch.setattr(JRD, "_render_one_view",
                        _recording(seen_j, JRD._render_one_view))
    monkeypatch.setattr(TRD, "render_view",
                        _recording(seen_t, TRD.render_view))
    try:
        fn, args = GE.entry()
        # the recorded overflow is a tracer of the same trace, so one
        # compile returns the image and the overflow together
        want, want_ovf = jax.jit(lambda *a: (fn(*a), seen_j[-1]))(*args)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    want = np.asarray(want)

    fn_t, args_t = TE.entry(device="cpu")
    params = TE.params_from_jax(jax.tree_util.tree_map(np.asarray, args[0]),
                                device="cpu")
    assert sorted(params) == sorted(args_t[0])
    with torch.no_grad():
        got = fn_t(params, *args_t[1:])
    assert tuple(got.shape) == want.shape == (12, TE.HW, TE.HW)
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    assert float(np.abs(want[0:3]).max()) > 0.1  # the view sees the cloud
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert len(seen_t) == 1
    assert int(seen_t[0]) == int(want_ovf) == 0


def test_port_plan_holds_every_voxel_past_the_jax_caps():
    """The JAX entry's default plan (capacities n, n, n/2, n/4) keeps
    only 128 of the 244 voxels of level 2, and 64 of the 99 that those
    128 give at level 3, where the whole cloud gives 195; the port's plan
    keeps every voxel of every level."""
    from gpcr_tpu.ops import sparse as JS

    coords, rgb = GE._tiny_scene()[:2]
    info = JE.PCMLInfo(clr_encoder_channels="9 16 16 16 16 16",
                       scale_factor=96)
    jgrid = JS.quantize_average(coords, JE.assemble_input_features(
        info, coords, rgb))
    jplan = JE.PCEncoder(info).build_plan(jgrid)
    unique = [int(g.num) for g in jplan["grids"]]
    kept = [min(int(g.num), g.capacity) for g in jplan["grids"]]
    assert unique == LEVEL_VOXELS[:3] + [99]
    assert [g.capacity for g in jplan["grids"]] == JAX_CAPS
    assert kept == [255, 252, 128, 64]

    coords, rgb = TE._tiny_scene(device="cpu")[:2]
    grid = TE.sparse.quantize_average(
        coords, TE.assemble_input_features(TE.INFO, coords, rgb))
    plan = TE.PCEncoder(TE.INFO).build_plan(grid)
    assert [g.num for g in plan["grids"]] == LEVEL_VOXELS


def test_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (TE.entry, TE._tiny_scene,
                 lambda: TE.params_from_jax({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fn, args = TE.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[0].values())
    assert all(t.device.type == "cpu" for t in args[1:])
    with torch.no_grad():
        out = fn(*args)
    assert tuple(out.shape) == (12, TE.HW, TE.HW)
    assert bool(torch.isfinite(out).all())
    assert not out.requires_grad


def test_entry_weights_come_from_the_generator():
    """Seed 0 unless a generator is passed; another seed, other weights."""
    p0 = TE.entry(device="cpu")[1][0]
    same = TE.entry(device="cpu",
                    generator=torch.Generator().manual_seed(0))[1][0]
    other = TE.entry(device="cpu",
                     generator=torch.Generator().manual_seed(1))[1][0]
    assert all(torch.equal(p0[k], same[k]) for k in p0)
    assert any(not torch.equal(p0[k], other[k]) for k in p0)


def test_main_on_the_cpu_runs_entry_and_the_dry_run(capsys):
    """``python -m gpcr_tpu_torch.entry --device cpu``: the image, then
    ``dryrun_multichip`` in one gloo process."""
    assert TE.main(["--device", "cpu"]) == (12, TE.HW, TE.HW)
    out = capsys.readouterr().out
    assert "entry ok: (12, 32, 32)" in out

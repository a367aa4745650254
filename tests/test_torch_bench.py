"""The port's benchmark and demo entry points (``gpcr_tpu_torch/bench.py``,
``gpcr_tpu_torch/scripts/``) against the JAX scripts they are twins of,
on the CPU at tiny sizes.

The JAX scripts are loaded by file path; their persistent compilation
cache goes to a temporary directory (``GPCR_JAX_CACHE``), and JAX's cache
settings are restored after each test. Where a JAX script builds its
inputs inline, the test runs it with a stand-in for the first function it
hands them to, which records its arguments and stops the script.

Tolerances: the clouds bit for bit; configs field for field (without
the JAX-only fields of ``DROPPED_FIELDS``, which the port drops);
renders at atol 1e-5 (tests/test_torch_render.py's SimpleRender bar);
the demo's held-out PSNR at 1e-4 dB and its loss at rtol 1e-4
(tests/test_torch_train.py's bar), with weights carried across by
``load_jax_params``.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.models import encoder as JE
from gpcr_tpu.ops import rasterize as JR
from gpcr_tpu.render import renderer as JRD
from gpcr_tpu.train import trainer as JT
from gpcr_tpu_torch import bench as TB
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.render.checkpoint import load_jax_params
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.scripts import bench_matrix as TBM
from gpcr_tpu_torch.scripts import bench_train_step as TBT
from gpcr_tpu_torch.scripts import train_demo as TTD
from gpcr_tpu_torch.cli.profile_pcrender import synthetic_cloud

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)
pin_fp32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# RasterizeConfig fields the port drops: the TPU's one-pass bf16 feature
# contraction (the CUDA kernel accumulates in float32), the scan-based
# backward's chunk cap and scan, the forward path's name, grid steps and
# transmittance scans (ROADMAP "Not queued")
DROPPED_FIELDS = {"feat_precision", "max_chunks", "scan_impl", "impl",
                  "tiles_per_step", "scan"}
CACHE_FLAGS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


class _Stop(Exception):
    """Raised by a stand-in once it has recorded what it was given."""


@pytest.fixture
def jax_script(monkeypatch, tmp_path):
    """A loader of the repository's JAX scripts by path (``bench.py``,
    ``scripts/<name>.py``) whose compilation cache stays in ``tmp_path``."""
    monkeypatch.setenv("GPCR_JAX_CACHE", str(tmp_path / "jax_cache"))
    saved = {k: getattr(jax.config, k) for k in CACHE_FLAGS}

    def load(rel):
        name = "jax_script_" + rel.replace("/", "_")[:-3]
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    for k, v in saved.items():
        jax.config.update(k, v)


def _recorder(seen):
    """A stand-in that records its arguments and stops the caller."""
    def record(*args, **kwargs):
        seen.append((args, kwargs))
        raise _Stop
    return record


def _jax_train_step_inputs(jax_script, monkeypatch, points):
    """Run scripts/bench_train_step.py until it calls its jitted gradient:
    (the loss function's free variables, the argument values)."""
    mod = jax_script("scripts/bench_train_step.py")
    seen = []

    def jit(fn):
        def call(*argvals):
            seen.append((fn, argvals))
            raise _Stop
        return call

    monkeypatch.setattr(mod, "jax", types.SimpleNamespace(
        jit=jit, value_and_grad=lambda fn, argnums: fn))
    monkeypatch.setattr(sys, "argv", ["bench_train_step.py", "--points",
                                      str(points)])
    with pytest.raises(_Stop):
        mod.main()
    loss, argvals = seen[0]
    free = dict(zip(loss.__code__.co_freevars,
                    (c.cell_contents for c in loss.__closure__)))
    return free, [np.asarray(a) for a in argvals]


def _port_train_step(points, res=512):
    args = TBT.build_parser().parse_args(
        ["--device", "cpu", "--points", str(points), "--res", str(res)])
    return TBT.build(args, torch.device("cpu"))


# --------------------------------------------------------------------------
# 1. the clouds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["matrix", "matrix_quantized", "pcrender",
                                    "train_step"])
def test_clouds_equal_the_jax_scripts(source, jax_script, monkeypatch,
                                      tmp_path):
    if source.startswith("matrix"):
        jbm = jax_script("scripts/bench_matrix.py")
        quantize = source == "matrix_quantized"
        sf = 256 if quantize else 448
        want = jbm.make_cloud(5000, sf, seed=3, quantize=quantize)
        got = TBM.make_cloud(5000, sf, seed=3, quantize=quantize)
        if quantize:
            assert len(got[0]) < 5000  # some points shared a voxel
    elif source == "pcrender":
        import gpcr_tpu.io.ply as jply
        import gpcr_tpu.render.checkpoint as jck

        mod = jax_script("scripts/bench_pcrender.py")
        seen = []
        monkeypatch.setattr(jply, "write_ply", _recorder(seen))
        monkeypatch.setattr(jck, "save_params", lambda path, params: None)
        monkeypatch.setattr(JE, "PCEncoder", lambda info: types.SimpleNamespace(
            init=lambda key: {}))
        monkeypatch.setattr(mod.tempfile, "mkdtemp",
                            lambda prefix: str(tmp_path / "jax_pcrender"))
        monkeypatch.setattr(sys, "argv", ["bench_pcrender.py", "700", "448"])
        with pytest.raises(_Stop):
            mod.main()
        want = seen[0][0][1:3]
        got = synthetic_cloud(700, 448, seed=0)
    else:
        _, argvals = _jax_train_step_inputs(jax_script, monkeypatch, 700)
        leaves, _, _ = _port_train_step(700)
        want = [argvals[0], argvals[4]]  # means, colours
        got = [leaves[0].numpy(), leaves[4].numpy()]
        for a, b in zip(argvals[1:4], leaves[1:4]):  # scales, rots, opacity
            np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# 2. the configs
# --------------------------------------------------------------------------


def _assert_same_config(port, want):
    assert type(port)._fields == tuple(
        f for f in type(want)._fields if f not in DROPPED_FIELDS)
    for f in port._fields:
        assert getattr(port, f) == getattr(want, f), f


def _train_demo_setup(jax_script, monkeypatch, tmp_path):
    """What scripts/train_demo.py and its twin give their trainer and
    their two loaders at the default flags: ({"trainer", "optimizer",
    "loaders"}) per package. The JAX script stops at
    ``make_train_step``."""
    import gpcr_tpu.train.data as jdata
    import gpcr_tpu_torch.train.data as tdata
    import gpcr_tpu_torch.train.trainer as ttrainer

    mod = jax_script("scripts/train_demo.py")
    got = {"jax": {"loaders": []}, "port": {"loaders": []}}

    def loader(side):
        def make(**kw):
            got[side]["loaders"].append(kw)
            return types.SimpleNamespace(next_batch=lambda: None)
        return make

    def jax_trainer(**kw):
        got["jax"]["trainer"] = kw
        return types.SimpleNamespace(
            init=lambda key: (None, None),
            make_train_step=_recorder([]))

    monkeypatch.setattr(JT, "make_optimizer", lambda lr, warmup: (lr, warmup))
    monkeypatch.setattr(JT, "Trainer", jax_trainer)
    monkeypatch.setattr(jdata, "DataLoader", loader("jax"))
    monkeypatch.setattr(sys, "argv", ["train_demo.py", "--cpu", "--out",
                                      str(tmp_path / "jax_demo")])
    with pytest.raises(_Stop):
        mod.main()
    got["jax"]["optimizer"] = got["jax"]["trainer"].pop("optimizer")

    def port_trainer(**kw):
        got["port"]["optimizer"] = (kw.pop("learning_rate"),
                                    kw.pop("num_warmup_steps"))
        got["port"]["trainer"] = kw
    monkeypatch.setattr(ttrainer, "Trainer", port_trainer)
    monkeypatch.setattr(tdata, "DataLoader", loader("port"))
    TTD.build(TTD.build_parser().parse_args(["--device", "cpu"]))
    return got


@pytest.mark.parametrize("which", ["c1", "c3a", "c4", "c5", "bench",
                                   "train_step", "train_demo"])
def test_configs_equal_the_jax_scripts(which, jax_script, monkeypatch,
                                       tmp_path):
    seen_jax, seen_port = [], []
    if which == "train_demo":
        got = _train_demo_setup(jax_script, monkeypatch, tmp_path)
        jax_side, port = got["jax"], got["port"]
        assert port["trainer"]["info"] == jax_side["trainer"]["info"]
        assert port["trainer"]["render_hw"] == jax_side["trainer"][
            "render_hw"] == (48, 48)
        assert port["optimizer"] == jax_side["optimizer"] == (1e-3, 100)
        for p, j in zip(port["loaders"], jax_side["loaders"]):
            assert p.pop("device") == torch.device("cpu")
            assert p == j
        assert len(port["loaders"]) == len(jax_side["loaders"]) == 2
        return
    if which == "train_step":
        free, _ = _jax_train_step_inputs(jax_script, monkeypatch, 100)
        _, settings, config = _port_train_step(100)
        _assert_same_config(config, free["config"])
        assert (settings.image_height, settings.image_width) == (1024, 1024)
        assert settings.sh_degree == free["settings"].sh_degree == 0
        return
    if which == "bench":
        monkeypatch.setattr(JRD, "render_views_fused", _recorder(seen_jax))
        monkeypatch.setattr(sys, "argv", ["bench.py", "--points", "64",
                                          "--autotune_kb", ""])
        mod = jax_script("bench.py")
        monkeypatch.setattr(TBM, "render", lambda scene, config, idx:
                            _recorder(seen_port)(config))
        with pytest.raises(_Stop):
            mod.main()
        with pytest.raises(_Stop):
            TB.main(["--device", "cpu", "--points", "64"])
    else:
        mod = jax_script("scripts/bench_matrix.py")
        for m, seen in ((mod, seen_jax), (TBM, seen_port)):
            # the config does not depend on the cloud: draw a tiny one
            real = m.make_cloud
            monkeypatch.setattr(
                m, "make_cloud", lambda n, sf, seed=0, quantize=False,
                real=real: real(64, sf, seed, quantize))
        monkeypatch.setattr(mod, "render_views_fused", _recorder(seen_jax))
        monkeypatch.setattr(TBM, "render", lambda scene, config, idx:
                            _recorder(seen_port)(config))
        monkeypatch.setattr(sys, "argv", ["bench_matrix.py", which])
        with pytest.raises(_Stop):
            mod.main()
        with pytest.raises(_Stop):
            TBM.main([which, "--device", "cpu"])
    _assert_same_config(seen_port[0][0][0], seen_jax[0][1]["config"])


# --------------------------------------------------------------------------
# 3. the render and the binning report
# --------------------------------------------------------------------------


def _jax_binning_report(arrays, rp, config, max_active):
    """The JAX scripts' overflow sanity (bench.py:203-224) on the same
    arrays."""
    n = arrays["means"].shape[0]
    settings = JR.GaussianRasterizationSettings(
        rp["height"], rp["width"], rp["tanfov"], rp["tanfov"], jnp.ones(12),
        1.0, rp["view_t"][0], rp["full_t"][0], 1, rp["campos"][0])
    prep = JR.preprocess(arrays["means"], arrays["opacity"], settings, config,
                         scales=arrays["scales"],
                         rotations=arrays["rotations"],
                         colors_precomp=jnp.zeros((n, 12)))
    gx = -(-rp["width"] // config.tile_x)
    nt = gx * (-(-rp["height"] // config.tile_y))
    _, starts, ovf = JR.tile_bin(prep, nt, gx, config)
    counts = np.asarray(starts[1:] - starts[:-1])
    n_nonempty = int((counts > 0).sum())
    dropped_tiles = max(0, n_nonempty - max_active) if max_active else 0
    dropped_entries = (int(np.sort(counts)[::-1][max_active:].sum())
                       if dropped_tiles else 0)
    return dict(overflow=int(np.asarray(ovf)), nonempty_tiles=n_nonempty,
                dropped_tiles=dropped_tiles, dropped_entries=dropped_entries)


def test_render_and_binning_report_match_jax():
    """3,000 points, 32² x2, 2 views, dup cap 1 (so that some entries are
    dropped, and counted by both). The JAX renderer takes its exact XLA
    path on the CPU, which has no ``max_active_tiles``; the binning
    report is compared with a tile budget small enough to drop tiles."""
    coords, rgb = TBM.make_cloud(3000, 448)
    scene = TBM.make_scene(coords, rgb, 448, 32, 32, 2, device="cpu")
    config = TBM.raster_config(1, None, None)
    got = TBM.render(scene, config, [0, 1])

    arrays = {k: jnp.asarray(scene[k].numpy())
              for k in ("means", "scales", "rotations", "opacity", "shs",
                        "normal", "valid")}
    rp = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
          for k, v in scene["rp"].items()}
    jcfg = JR.RasterizeConfig(max_dup_per_gaussian=1, chunk_size=256,
                              impl="stream")
    want = JRD.render_views_fused(
        rp["view_t"], rp["full_t"], rp["campos"], arrays["means"],
        arrays["scales"], arrays["rotations"], arrays["opacity"],
        arrays["shs"], arrays["normal"], arrays["valid"], jnp.ones(3),
        rp["tanfov"], height=64, width=64, out_h=32, out_w=32, sh_degree=1,
        config=jcfg, with_normal=False)
    for k in ("rgb", "xyz_w", "hitmap"):
        assert got[k].shape == (2, 32, 32, 3), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    assert float(got["hitmap"].max()) > 0.5
    ovf = got["dup_overflow"].numpy()
    np.testing.assert_array_equal(ovf, np.asarray(want["dup_overflow"]))
    assert ovf.min() > 0

    report = TBM.binning_report(scene, config._replace(max_active_tiles=3), 3)
    want_report = _jax_binning_report(
        arrays, rp, jcfg._replace(max_active_tiles=3), 3)
    assert report == want_report
    assert report["dropped_tiles"] > 0 and report["dropped_entries"] > 0


# --------------------------------------------------------------------------
# 4. the headline entry point
# --------------------------------------------------------------------------


def test_bench_prints_one_json_line_then_the_hash_line():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "gpcr_tpu_torch.bench", "--device", "cpu",
         "--points", "2000", "--res", "32", "--frames", "2",
         "--views_per_dispatch", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout
    lines = r.stdout.splitlines()
    json_lines = [i for i, line in enumerate(lines) if line.startswith("{")]
    assert len(json_lines) == 1, lines
    line = json.loads(lines[json_lines[0]])
    assert sorted(line) == ["metric", "unit", "value"]
    assert line["metric"] == "render_ms_per_frame_800k_1024"
    assert line["unit"] == "ms"
    assert math.isfinite(line["value"]) and line["value"] > 0
    hashes = [i for i, line in enumerate(lines) if line.startswith("# frames=")]
    assert len(hashes) == 1 and hashes[0] > json_lines[0], lines
    for key in ("times_ms=", "k_budget=1800000", "device=cpu",
                "nonempty_tiles=", "max_active=6144", "dropped_tiles=0",
                "dropped_entries=0", "render_dup_overflow=0"):
        assert key in lines[hashes[0]], key


def test_train_step_saves_live_rows_only():
    """With a ``k_budget`` far above the entries, the autograd Function
    keeps the kept entries' rows only (no row bound of k_budget)."""
    leaves, settings, config = _port_train_step(600, res=32)
    means, scales, rots, opacity, feats = leaves
    for x in (means, scales, opacity, feats):
        x.requires_grad_(True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        color, _ = TR.rasterize_gaussians(
            means, opacity, settings, scales=scales, rotations=rots,
            colors_precomp=feats, config=config)
    torch.mean((color - 0.5) ** 2).backward()
    with torch.no_grad():
        prep = TR.preprocess(means, opacity, settings, config, scales=scales,
                             rotations=rots, colors_precomp=feats)
        entries = int(TR.entry_count(prep, config))
    assert 0 < entries < 600 * 8
    assert config.k_budget == 6_000_000
    assert (entries, 8 + 3) in shapes  # the stream rows
    assert max(s[0] for s in shapes if s) == max(entries, 600)
    assert all(torch.isfinite(x.grad).all() for x in (means, feats))


# --------------------------------------------------------------------------
# 5. the training demo
# --------------------------------------------------------------------------


class _AllVoxels(JE.PCEncoder):
    """The JAX encoder with every U-Net level's capacity at the cloud's
    size: the JAX trainer caps the coarse levels at n/2 and n/4 voxels and
    drops the rest, which the demo's sparse clouds overflow (the port
    holds exactly each level's voxels; ROADMAP §3)."""

    def build_plan(self, grid, level_capacity=None, brick_capacity=None):
        n = grid.capacity
        return super().build_plan(grid, [n] * 4, brick_capacity)


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()
           if k != "tanfov"}
    out["tanfov"] = batch["tanfov"]
    return out


def test_train_demo_step0_matches_jax_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--hw", "16", "--n_points", "256",
            "--eval_every", "1", "--ckpt_every", "1", "--warmup", "2",
            "--out", str(tmp_path / "demo")]
    args = TTD.build_parser().parse_args(argv)
    trainer, loader, eval_batch = TTD.build(args)
    jtr = JT.Trainer(info=TTD.INFO, render_hw=(16, 16),
                     optimizer=JT.make_optimizer(args.lr, args.warmup),
                     model=_AllVoxels(TTD.INFO, conv_block=None))
    params, _ = jtr.init(jax.random.PRNGKey(0))
    load_jax_params(trainer.model, jax.tree_util.tree_map(np.asarray, params))

    want = float(jtr.make_eval_psnr()(params, _jax_batch(eval_batch)))
    got = float(trainer.eval_psnr(eval_batch))
    assert 5.0 < want < 40.0
    assert abs(got - want) <= 1e-4, (got, want)
    batch = loader.next_batch()
    want_loss, _ = jax.jit(jtr.loss_fn)(params, _jax_batch(batch))
    got_loss, _ = trainer.loss_fn(batch)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-4)

    first = TTD.main(argv + ["--steps", "2"])
    assert first["start_step"] == 0
    assert [h["step"] for h in first["history"]] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in first["history"][1:])
    resumed = TTD.main(argv + ["--steps", "3", "--resume"])
    assert resumed["start_step"] == 2
    assert resumed["psnr_start"] == first["history"][-1]["psnr"]
    assert [h["step"] for h in resumed["history"]] == [0, 1, 2, 3]
    assert resumed["trainer"].optimizer.count == 3
    assert os.path.isfile(tmp_path / "demo" / "train_state.pt")

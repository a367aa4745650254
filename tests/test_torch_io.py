"""The port's own file readers and writers, and the rule that the port
imports nothing of the JAX package.

(a) every ``*.py`` under ``gpcr_tpu_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; any import of ``jax``, ``flax``, ``optax`` or the
bare ``gpcr_tpu`` package fails the test. (b) PLY and PNG files written by
the port are read by ``gpcr_tpu.io`` and the other way round, with
byte-equal arrays.
"""

import ast
import os

import numpy as np
import pytest

from gpcr_tpu.io import image as jimage
from gpcr_tpu.io import ply as jply
from gpcr_tpu_torch import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "flax", "optax", "gpcr_tpu"}


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gpcr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_imports_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 30  # the walk really found the package
    walked = {os.path.relpath(p, REPO) for p in files}
    for name in ("metrics/psnr.py", "metrics/ssim.py", "metrics/lpips.py",
                 "cli/pic_metrics.py", "cli/convert_lpips.py",
                 "ops/rasterize_aligned.py", "structures/reconstruct.py"):
        assert os.path.join("gpcr_tpu_torch", name) in walked, name
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_between_packages(tmp_path, binary):
    rng = np.random.RandomState(0)
    xyz = rng.randn(50, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (50, 3)).astype(np.float32) / 255.0
    normal = rng.randn(50, 3).astype(np.float32)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tio.write_ply(a, xyz, rgb, normal, binary=binary)
    jply.write_ply(b, xyz, rgb, normal, binary=binary)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (a, b):
        got_j, got_t = jply.read_ply(path), tio.read_ply(path)
        assert sorted(got_t) == sorted(got_j) == ["normal", "rgb", "xyz"]
        for k in got_t:
            np.testing.assert_array_equal(got_t[k], got_j[k])
    got = tio.read_ply(a)
    if binary:
        np.testing.assert_array_equal(got["xyz"], xyz)
    np.testing.assert_array_equal(
        np.round(got["rgb"] * 255), np.round(rgb * 255))
    with pytest.raises(FileExistsError):
        tio.write_ply(a, xyz, overwrite=False)


def test_png_round_trip_between_packages(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    tio.write_png(a, img)
    jimage.write_png(b, img)
    for path in (a, b):
        np.testing.assert_array_equal(tio.read_png(path), img)
        np.testing.assert_array_equal(jimage.read_png(path), img)
    # the pure-python codec (used where imageio is missing) too
    c = str(tmp_path / "pure.png")
    tio.image._write_png_pure(c, img)
    np.testing.assert_array_equal(jimage.read_png(c), img)
    np.testing.assert_array_equal(tio.image._read_png_pure(b), img)
    f = rng.rand(4, 5, 3).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(tio.to_uint8(f), jimage.to_uint8(f))


def test_save_pic_matches_jax_package(tmp_path):
    rng = np.random.RandomState(2)
    img = rng.rand(1, 2, 8, 8, 3).astype(np.float32) * 2 - 1
    hit = (rng.rand(1, 2, 8, 8, 1) > 0.5).astype(np.float32)
    for kind in ("rgb", "normal_w", "xyz_w"):
        tio.save_pic(img, str(tmp_path / "t"), type=kind, hit_map=hit)
        jimage.save_pic(img, str(tmp_path / "j"), type=kind, hit_map=hit)
        for iq in range(2):
            np.testing.assert_array_equal(
                tio.read_png(str(tmp_path / "t" / f"{kind}_{iq}.png")),
                tio.read_png(str(tmp_path / "j" / f"{kind}_{iq}.png")))

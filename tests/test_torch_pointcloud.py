"""The data half of the port's ``PointCloud`` against ``gpcr_tpu`` on the
same seeded numpy inputs, and the port's native PLY parser against its
Python reader.

Tolerances: ``voxel_downsampling`` at 1e-6 abs on xyz and 1e-5 on the
averaged attributes, with equal valid masks (both sum the same float32
values, the segment sums in their own order); the JAX side runs with
``jax_enable_x64``, without which its int64 cell keys overflow.
``cat`` / ``pad_to`` / ``extract_valid_point_cloud`` / ``state_dict`` /
``save``, ``remove_outlier``'s masks and the PLY readers: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu.io import ply as jply
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu_torch import native_bindings as TNB
from gpcr_tpu_torch.io import ply as tply
from gpcr_tpu_torch.structures.pointcloud import PointCloud

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

ATTRS = PointCloud._ATTRS


def _attrs(n=64, b=2, seed=0, padded=True):
    """Seeded (b, n, ·) arrays of all 11 attributes; with ``padded`` some
    points invalid and a padded tail on the last batch item."""
    rng = np.random.RandomState(seed)

    def f(*s):
        return rng.rand(b, n, *s).astype(np.float32)

    d = {
        "xyz_w": f(3) * 6.0, "rgb": f(3), "normal_w": f(3) * 2 - 1,
        "feature": f(5), "captured_z_direction_w": f(3) * 2 - 1,
        "captured_view_direction_w": f(3) * 2 - 1, "captured_dps": f(1),
        "captured_dps_u_w": f(3), "captured_dps_v_w": f(3),
        "img_idxs": np.arange(b * n, dtype=np.int32).reshape(b, n, 1),
    }
    vm = np.ones((b, n, 1), bool)
    if padded:
        vm[0, ::7] = False
        vm[-1, n - n // 4:] = False
        d["xyz_w"][-1, n - n // 4:] = 0.0
    d["valid_mask"] = vm
    return d


def _pair(d):
    return (JPointCloud(**{k: jnp.asarray(v) for k, v in d.items()}),
            PointCloud(**{k: torch.as_tensor(v) for k, v in d.items()}))


def _assert_same(got, want, exact=True, tol=None):
    for k in ATTRS:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is None:
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if exact or k == "valid_mask":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=tol(k), err_msg=k)


@pytest.mark.parametrize("drop_features", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_voxel_downsampling_matches_jax(padded, drop_features):
    jp, tp = _pair(_attrs(padded=padded))
    with jax.enable_x64(True):
        want = jp.voxel_downsampling(1.0, drop_features=drop_features)
        want = JPointCloud(**{k: (None if getattr(want, k) is None
                                  else np.asarray(getattr(want, k)))
                              for k in ATTRS})
    got = tp.voxel_downsampling(1.0, drop_features=drop_features)
    assert got.xyz_w.shape == tp.xyz_w.shape  # the padded length stays
    n_cells = int(got.get_valid_mask().sum())
    assert 0 < n_cells < int(tp.get_valid_mask().sum())
    _assert_same(got, want, exact=False,
                 tol=lambda k: 1e-6 if k == "xyz_w" else 1e-5)
    if drop_features:
        assert got.captured_dps is None and got.feature is not None
    else:
        assert got.captured_dps is not None
    assert got.img_idxs is None
    # direction attributes are unit length on the valid cells
    m = got.get_valid_mask()[..., 0]
    norms = torch.linalg.norm(got.normal_w[m], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)
    assert tp.voxel_downsampling(-1.0) is tp


def test_voxel_downsampling_one_point_per_cell():
    """No padding and every point in a cell of its own: the last slot is
    a real cell, not only where invalid points would land."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    xyz = (g.reshape(1, -1, 3) * 3.0 + 0.25).astype(np.float32)
    rgb = np.random.RandomState(1).rand(*xyz.shape).astype(np.float32)
    with jax.enable_x64(True):
        want = JPointCloud.from_numpy(xyz, rgb).voxel_downsampling(1.0)
    got = PointCloud.from_numpy(xyz, rgb).voxel_downsampling(1.0)
    assert bool(got.get_valid_mask().all())
    np.testing.assert_array_equal(got.valid_mask.numpy(),
                                  np.asarray(want.valid_mask))
    np.testing.assert_allclose(got.xyz_w.numpy(), np.asarray(want.xyz_w),
                               atol=1e-6)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               atol=1e-5)


def test_cat_pad_extract_and_state_dict_match_jax(tmp_path):
    d1 = _attrs(n=30, b=1, seed=1)
    d2 = {k: v[:, :17] for k, v in _attrs(n=30, b=2, seed=2).items()}
    d2.pop("feature")
    (j1, t1), (j2, t2) = _pair(d1), _pair(d2)
    _assert_same(PointCloud.cat([t1, t2]), JPointCloud.cat([j1, j2]))
    got = PointCloud.cat([t2, t2], dim=0)
    _assert_same(got, JPointCloud.cat([j2, j2], dim=0))
    _assert_same(t2.pad_to(25), j2.pad_to(25))
    bare = PointCloud.from_numpy(d1["xyz_w"])
    assert bare.pad_to(30).valid_mask is not None
    with pytest.raises(ValueError):
        t1.pad_to(10)
    for bidx in (0, 1):
        _assert_same(t2.extract_valid_point_cloud(bidx),
                     j2.extract_valid_point_cloud(bidx))
    _assert_same(t1[0], j1[0])

    sd, jsd = t2.state_dict(), j2.state_dict()
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    _assert_same(PointCloud.from_state_dict(jsd), j2)

    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    t2.save(a, bidx=1)
    j2.save(b, bidx=1)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(FileExistsError):
        t2.save(a, overwrite=False)


@pytest.mark.parametrize("radius,min_neighbors", [(0.1, 2), (0.25, 3),
                                                  (0.6, 8)])
def test_remove_outlier_matches_jax(radius, min_neighbors):
    """A gaussian cluster with planted far outliers and some invalid
    points; the port's vectorised count (in chunks of 37 points, so that
    chunks split the cells) gives the reference loop's mask."""
    rng = np.random.RandomState(5)
    xyz = np.concatenate([rng.randn(300, 3) * 0.3,
                          rng.rand(15, 3) * 20 - 10]).astype(np.float32)
    vm = np.ones((1, len(xyz), 1), bool)
    vm[0, 5:9] = False
    want = JPointCloud(xyz_w=jnp.asarray(xyz[None]),
                       valid_mask=jnp.asarray(vm)).remove_outlier(
        radius, min_neighbors)
    got = PointCloud(xyz_w=torch.as_tensor(xyz[None]),
                     valid_mask=torch.as_tensor(vm)).remove_outlier(
        radius, min_neighbors, chunk=37)
    mask = got.valid_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.valid_mask))
    assert not mask[0, 300:].any() and mask[0, :300].sum() > 0


@pytest.mark.parametrize("binary", [True, False])
def test_native_ply_parser_matches_python_reader(tmp_path, binary):
    rng = np.random.RandomState(3)
    xyz = (rng.randn(257, 3) * 100).astype(np.float32)
    rgb = (np.arange(257 * 3) % 256).reshape(257, 3).astype(np.float32) / 255
    nrm = rng.randn(257, 3).astype(np.float32)
    path = str(tmp_path / "c.ply")
    tply.write_ply(path, xyz, rgb, nrm, binary=binary)
    want = tply.read_ply_python(path)
    native = TNB.read_ply_native(path)
    if TNB.get_ply_parser() is None:
        assert native is None  # no g++ here: the Python reader reads all
    elif binary:
        assert sorted(native) == sorted(want) == ["normal", "rgb", "xyz"]
        for k in want:
            np.testing.assert_array_equal(native[k], want[k], err_msg=k)
    else:
        assert native is None  # the parser declines ASCII
    got, jgot = tply.read_ply(path), jply.read_ply(path)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(jgot[k], want[k])
    # xyz alone, and a file the parser cannot read at all
    tply.write_ply(path, xyz, binary=binary)
    assert sorted(tply.read_ply(path)) == ["xyz"]
    assert TNB.read_ply_native(str(tmp_path / "missing.ply")) is None


def test_failed_native_build_raises(tmp_path, monkeypatch):
    import shutil

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(TNB, "_CACHE", {})
    monkeypatch.setattr(TNB, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(TNB, "_PLY_SRC", str(tmp_path / "missing.cpp"))
    assert TNB.get_ply_parser() is None
    monkeypatch.setattr(TNB, "_CACHE", {})
    monkeypatch.setattr(TNB, "_PLY_SRC", str(broken))
    monkeypatch.setattr(TNB, "_SE_SRC", str(broken))
    if shutil.which("g++") is None:
        assert TNB.get_ply_parser() is None
    else:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            TNB.get_ply_parser()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            TNB.sample_elimination(np.zeros((5, 3), np.float32), 2, 0.1)

"""The port's meshing (marching tetrahedra, Poisson, alpha shape,
``PointCloud.get_mesh``) and uv re-atlas (``remesh`` / ``remesh_file``)
against ``gpcr_tpu`` on the same seeded numpy inputs.

Tolerances: the meshes are host numpy copies with the same order of
operations, so vertices and triangles are equal exactly; ``remesh``'s uvs
are equal to 1e-6 (they are in fact bit-equal) and ``remesh_file`` writes
the same bytes.
"""

import numpy as np
import pytest
import torch

from gpcr_tpu.structures import mesh as JM
from gpcr_tpu.structures import reconstruct as JREC
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu_torch.structures import mesh as TM
from gpcr_tpu_torch.structures import reconstruct as TREC
from gpcr_tpu_torch.structures.pointcloud import PointCloud

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)


def _sphere(n, seed=0, solid=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.rand(n) ** (1 / 3) if solid else np.ones(n)
    return (v * r[:, None]).astype(np.float32), v.astype(np.float32)


def _assert_mesh_equal(got_v, got_f, want_v, want_f):
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
    assert np.asarray(got_v).dtype == np.asarray(want_v).dtype
    assert np.asarray(got_f).dtype == np.asarray(want_f).dtype


def _edge_counts(f):
    f = np.asarray(f)
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [0, 2]]]),
                    axis=1)
    return np.unique(edges, axis=0, return_counts=True)[1]


def test_marching_tetrahedra_matches_jax():
    x = np.linspace(-1.2, 1.2, 14)
    xx, yy, zz = np.meshgrid(x, x, x, indexing="ij")
    field = 1.0 - np.sqrt(xx ** 2 + (1.3 * yy) ** 2 + zz ** 2)
    kw = dict(iso=0.1, origin=(-1.2, -1.2, -1.2), spacing=2.4 / 13)
    want = JREC.marching_tetrahedra(field, **kw)
    got = TREC.marching_tetrahedra(field, **kw)
    _assert_mesh_equal(*got, *want)
    assert len(got[1]) > 100 and (_edge_counts(got[1]) == 2).all()
    empty = TREC.marching_tetrahedra(np.zeros((1, 4, 4)), 0.5)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_poisson_and_alpha_shape_match_jax():
    xyz, nrm = _sphere(3000, seed=1)
    _assert_mesh_equal(*TREC.poisson_mesh(xyz, nrm, depth=5),
                       *JREC.poisson_mesh(xyz, nrm, depth=5))
    ball, _ = _sphere(1500, seed=2, solid=True)
    got = TREC.alpha_shape_mesh(ball, 0.35)
    _assert_mesh_equal(*got, *JREC.alpha_shape_mesh(ball, 0.35))
    assert len(got[1]) > 100 and (_edge_counts(got[1]) == 2).all()


@pytest.mark.parametrize("method,kw,normals,solid", [
    ("voxel", dict(cell_width=0.15), False, False),
    ("poisson", dict(depth=5), True, False),
    ("poisson", dict(depth=4), False, False),  # normals estimated
    ("alpha", dict(alpha=0.35), False, True),
])
def test_get_mesh_matches_jax(method, kw, normals, solid):
    xyz, nrm = _sphere(1500, seed=3, solid=solid)
    valid = np.ones((1, len(xyz), 1), bool)
    valid[0, ::11] = False
    xyz[::11] = 50.0  # invalid points are left out
    jp = JPointCloud.from_numpy(xyz, normal=nrm if normals else None)
    jp = jp.replace(valid_mask=valid)
    tp = PointCloud.from_numpy(xyz, normal=nrm if normals else None).replace(
        valid_mask=torch.from_numpy(valid))
    want = jp.get_mesh(method=method, **kw)
    got = tp.get_mesh(method=method, **kw)
    assert isinstance(got, TM.Mesh)
    _assert_mesh_equal(got.vertices, got.triangles, want.vertices, want.triangles)
    assert len(got.triangles) > 50
    counts = _edge_counts(got.triangles)
    # closed surfaces: every edge on an even number of triangles (two cells
    # that share only an edge give 4)
    assert (counts % 2 == 0).all(), np.unique(counts)
    if method == "voxel":
        np.testing.assert_array_equal(got.material_ids, want.material_ids)


def test_get_mesh_ball_pivot_raises_in_both():
    xyz, _ = _sphere(64)
    for pc in (JPointCloud.from_numpy(xyz), PointCloud.from_numpy(xyz)):
        with pytest.raises(NotImplementedError, match="ball_pivot"):
            pc.get_mesh(method="ball_pivot")


def _write_obj(path, seed=0):
    """A small uv-sphere OBJ with one degenerate (zero-area) triangle."""
    rng = np.random.RandomState(seed)
    nu, nv = 9, 5
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0.2, np.pi - 0.2, nv)
    uu, vv = np.meshgrid(u, v)
    xyz = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv),
                    np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    xyz += rng.randn(*xyz.shape) * 0.01
    faces = []
    for i in range(nv - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            faces += [(a, b, b + nu), (a, b + nu, a + nu)]
    faces.append((0, 0, 1))
    with open(path, "w") as f:
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in xyz)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    return len(faces)


@pytest.mark.parametrize("atlas_cols", [None, 5])
def test_remesh_matches_jax(tmp_path, atlas_cols):
    path = str(tmp_path / "s.obj")
    n_faces = _write_obj(path)
    want = JM.remesh(JM.Mesh(path, scale=None, center_w=None, clean=False),
                     atlas_cols=atlas_cols)
    got = TM.remesh(TM.Mesh(path, scale=None, center_w=None, clean=False),
                    atlas_cols=atlas_cols)
    assert got.triangle_uvs.shape == (n_faces, 3, 2)
    np.testing.assert_allclose(got.triangle_uvs, want.triangle_uvs, atol=1e-6)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    uv = got.triangle_uvs
    assert uv.min() >= 0.0 and uv.max() <= 1.0
    # each triangle inside its own atlas cell
    cols = atlas_cols or int(np.ceil(np.sqrt(n_faces)))
    rows = int(np.ceil(n_faces / cols))
    cell = np.floor(uv.mean(1) * [cols, rows]).astype(int)
    np.testing.assert_array_equal(cell[:, 1] * cols + cell[:, 0], np.arange(n_faces))


def test_remesh_file_writes_the_same_bytes(tmp_path):
    path = str(tmp_path / "s.obj")
    _write_obj(path, seed=1)
    a, b = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    JM.remesh_file(path, a)
    assert TM.remesh_file(path, b) == b
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = TM.load_obj(b)
    assert back["triangle_uvs"].shape[0] == len(back["triangles"])

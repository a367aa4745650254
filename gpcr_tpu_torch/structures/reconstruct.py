"""Surface reconstruction from point clouds on the host, in numpy (the
port's copy of ``gpcr_tpu/structures/reconstruct.py``):

- ``marching_tetrahedra``: iso-surface of a regular grid; each cell splits
  into 6 tetrahedra, vertices on shared grid edges are merged, so the
  surface is a connected, crack-free mesh;
- ``poisson_mesh``: grid Poisson reconstruction (Kazhdan's FFT
  formulation): splat the oriented normals onto a grid, solve
  ``laplacian(chi) = div(V)`` spectrally, extract ``chi`` at the mean of
  its values at the samples;
- ``alpha_shape_mesh``: Delaunay tetrahedra (scipy) with circumradius
  below alpha; the surface is every face of exactly one kept tetrahedron;
- ``estimate_normals``: PCA normals of the k nearest neighbours.

Dataset and debug tools, not on the render path: the float64 / float32
order of operations is the JAX package's, so both give the same meshes.
"""

from __future__ import annotations

import itertools
import typing as T

import numpy as np

# 6-tetrahedra decomposition of the unit cube (all share the main diagonal
# 0-7; corner ids are bit-packed (x | y<<1 | z<<2))
_CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)
_CORNER_OFFSETS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64
)


def marching_tetrahedra(
    values: np.ndarray,  # (nx, ny, nz) scalar field
    iso: float,
    origin=(0.0, 0.0, 0.0),
    spacing: float = 1.0,
) -> T.Tuple[np.ndarray, np.ndarray]:
    """Extract the ``values == iso`` surface. Returns (vertices (V, 3),
    triangles (F, 3)). Vertices on shared cell edges are merged, so the
    output is a connected mesh, not a triangle soup."""
    nx, ny, nz = values.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # global vertex ids of each cell corner, for all cells at once
    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
        indexing="ij",
    )
    cells = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)  # (C, 3)
    corner = cells[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (C, 8, 3)
    gid = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
    val = values.reshape(-1)[gid]  # (C, 8)

    tets_gid = gid[:, _CUBE_TETS].reshape(-1, 4)  # (C*6, 4)
    tets_val = val[:, _CUBE_TETS].reshape(-1, 4)
    inside = tets_val > iso  # (T, 4)
    code = (
        inside[:, 0].astype(np.int64)
        | (inside[:, 1] << 1)
        | (inside[:, 2] << 2)
        | (inside[:, 3] << 3)
    )

    # case -> list of triangles, each vertex an index pair into the tet's
    # 4 corners (edge between an inside and an outside corner)
    def one_in(i):
        o = [j for j in range(4) if j != i]
        return [[(i, o[0]), (i, o[1]), (i, o[2])]]

    def two_in(i, j):
        o = [k for k in range(4) if k not in (i, j)]
        # quad (i,o0) (i,o1) (j,o1) (j,o0) -> two triangles
        return [
            [(i, o[0]), (i, o[1]), (j, o[1])],
            [(i, o[0]), (j, o[1]), (j, o[0])],
        ]

    cases: T.Dict[int, list] = {}
    for i in range(4):
        cases[1 << i] = one_in(i)
        cases[15 ^ (1 << i)] = one_in(i)  # 3 inside = 1 outside, mirrored
    for i, j in itertools.combinations(range(4), 2):
        cases[(1 << i) | (1 << j)] = two_in(i, j)

    # per-case blocks of (n_tris, 3) edge endpoint lists
    tri_edges_a, tri_edges_b = [], []
    for c, tris in cases.items():
        sel = np.where(code == c)[0]
        if len(sel) == 0:
            continue
        for tri in tris:
            ea = np.stack([tets_gid[sel, p] for (p, q) in tri], axis=-1)
            eb = np.stack([tets_gid[sel, q] for (p, q) in tri], axis=-1)
            tri_edges_a.append(ea)
            tri_edges_b.append(eb)
    if not tri_edges_a:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    ea = np.concatenate(tri_edges_a)  # (F, 3) inside-corner grid ids
    eb = np.concatenate(tri_edges_b)  # (F, 3) outside-corner grid ids

    # unique vertex per undirected grid edge
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo.astype(np.int64) * (nx * ny * nz) + hi
    uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
    u_lo = (uniq // (nx * ny * nz)).astype(np.int64)
    u_hi = (uniq % (nx * ny * nz)).astype(np.int64)

    vals_flat = values.reshape(-1)
    v_lo, v_hi = vals_flat[u_lo], vals_flat[u_hi]
    t = np.clip((iso - v_lo) / np.where(v_hi != v_lo, v_hi - v_lo, 1.0), 0, 1)

    def grid_xyz(g):
        x = g // (ny * nz)
        y = (g // nz) % ny
        z = g % nz
        return np.stack([x, y, z], axis=-1).astype(np.float64)

    verts = grid_xyz(u_lo) + t[:, None] * (grid_xyz(u_hi) - grid_xyz(u_lo))
    verts = verts * spacing + np.asarray(origin, np.float64)
    tris = inv.reshape(-1, 3)
    # drop degenerate triangles (two corners on the same edge)
    good = (
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    )
    return verts.astype(np.float32), tris[good].astype(np.int64)


def poisson_mesh(
    xyz: np.ndarray,  # (N, 3)
    normals: np.ndarray,  # (N, 3) oriented outward
    depth: int = 6,
    pad: float = 0.1,
    smooth_sigma: float = 1.5,
) -> T.Tuple[np.ndarray, np.ndarray]:
    """Grid Poisson reconstruction: solve laplacian(chi) = div(V) where V is
    the splatted unit-normal field, then marching-tetrahedra the indicator
    at the mean sample value. ``depth`` sets the grid (2^depth + 1 per
    axis), matching o3d's octree-depth parameter in spirit."""
    n = 1 << depth
    lo = xyz.min(0)
    hi = xyz.max(0)
    span = float((hi - lo).max()) * (1 + 2 * pad)
    origin = (lo + hi) / 2 - span / 2
    spacing = span / n
    g = np.clip((xyz - origin) / spacing, 0, n - 1e-6)
    gi = g.astype(np.int64)
    gf = g - gi

    # trilinear splat of normals into the vector field
    V = np.zeros((3, n + 1, n + 1, n + 1), np.float64)
    for dx in (0, 1):
        wx = gf[:, 0] if dx else 1 - gf[:, 0]
        for dy in (0, 1):
            wy = gf[:, 1] if dy else 1 - gf[:, 1]
            for dz in (0, 1):
                wz = gf[:, 2] if dz else 1 - gf[:, 2]
                w = wx * wy * wz
                idx = (gi[:, 0] + dx, gi[:, 1] + dy, gi[:, 2] + dz)
                for c in range(3):
                    np.add.at(V[c], idx, w * normals[:, c])

    # spectral solve on the padded grid (periodic; the pad keeps the wrap
    # from touching the surface)
    m = n + 1
    k = np.fft.fftfreq(m) * 2 * np.pi
    kx, ky, kz = np.meshgrid(k, k, k, indexing="ij")
    if smooth_sigma > 0:  # Gaussian pre-smoothing of the splat
        gauss = np.exp(-0.5 * smooth_sigma**2 * (kx**2 + ky**2 + kz**2))
    else:
        gauss = 1.0
    Vf = [np.fft.fftn(V[c]) * gauss for c in range(3)]
    div = 1j * (kx * Vf[0] + ky * Vf[1] + kz * Vf[2])
    k2 = kx**2 + ky**2 + kz**2
    k2[0, 0, 0] = 1.0
    chi_f = -div / k2
    chi_f[0, 0, 0] = 0.0
    chi = np.real(np.fft.ifftn(chi_f))

    # iso level = mean indicator at the samples (o3d uses the same rule)
    samp = chi[gi[:, 0], gi[:, 1], gi[:, 2]]
    iso = float(samp.mean())
    return marching_tetrahedra(chi, iso, origin=origin, spacing=spacing)


def alpha_shape_mesh(
    xyz: np.ndarray, alpha: float
) -> T.Tuple[np.ndarray, np.ndarray]:
    """3D alpha shape (the construction of o3d's
    ``create_from_point_cloud_alpha_shape``): Delaunay tets filtered by
    circumradius < alpha; the surface is every face belonging to exactly
    one kept tet."""
    from scipy.spatial import Delaunay

    tri = Delaunay(xyz)
    tets = tri.simplices  # (M, 4)
    p = xyz[tets]  # (M, 4, 3)

    # circumradius: solve for the circumcenter via the linear system
    a, b, c, d = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    A = np.stack([b - a, c - a, d - a], axis=1)  # (M, 3, 3)
    rhs = 0.5 * np.stack(
        [
            (b**2 - a**2).sum(-1),
            (c**2 - a**2).sum(-1),
            (d**2 - a**2).sum(-1),
        ],
        axis=-1,
    )
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-12
    center = np.zeros((len(tets), 3))
    center[ok] = np.linalg.solve(A[ok], rhs[ok][..., None])[..., 0]
    radius = np.linalg.norm(center - a, axis=-1)
    keep = ok & (radius < alpha)

    faces = np.concatenate(
        [
            tets[keep][:, [0, 1, 2]],
            tets[keep][:, [0, 1, 3]],
            tets[keep][:, [0, 2, 3]],
            tets[keep][:, [1, 2, 3]],
        ]
    )
    faces_sorted = np.sort(faces, axis=1)
    uniq, counts = np.unique(faces_sorted, axis=0, return_counts=True)
    boundary = uniq[counts == 1]

    # compact vertex list
    used, inv = np.unique(boundary.reshape(-1), return_inverse=True)
    return xyz[used].astype(np.float32), inv.reshape(-1, 3).astype(np.int64)


def estimate_normals(
    xyz: np.ndarray, k: int = 30, orient: str = "outward"
) -> np.ndarray:
    """PCA normal estimation: per point, the eigenvector of the k-NN
    covariance with the smallest eigenvalue.

    ``orient='outward'`` flips normals away from the centroid (adequate for
    star-shaped objects). The renderer flips normals to face the camera at
    render time, so the sign only affects shading. The kNN is a chunked
    brute-force search, quadratic in the number of points: meant for the
    clouds of a few hundred thousand points that lack normals, not for
    every render."""
    n = len(xyz)
    k = min(k, n)
    normals = np.zeros((n, 3), np.float32)
    chunk = max(1, int(2e7) // max(n, 1))
    for s in range(0, n, chunk):
        q = xyz[s:s + chunk]
        d2 = ((q[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
        nb = xyz[idx]  # (c, k, 3)
        mu = nb.mean(1, keepdims=True)
        cen = nb - mu
        cov = np.einsum("cki,ckj->cij", cen, cen) / k
        w, v = np.linalg.eigh(cov)
        normals[s:s + chunk] = v[:, :, 0]  # smallest-eigenvalue axis
    if orient == "outward":
        out = xyz - xyz.mean(0)
        sgn = np.sign((normals * out).sum(-1, keepdims=True))
        sgn[sgn == 0] = 1.0
        normals = normals * sgn
    nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(nrm, 1e-12)).astype(np.float32)

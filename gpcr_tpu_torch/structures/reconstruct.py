"""Normal estimation on the host (the port's copy of
``gpcr_tpu/structures/reconstruct.py::estimate_normals``, numpy only; the
meshing half of that module is not ported yet)."""

from __future__ import annotations

import numpy as np


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

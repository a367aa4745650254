"""Triangle meshes and the ray-cast ground-truth oracle (port of
``gpcr_tpu/structures/mesh.py``).

Host-side numpy, as in the JAX package: OBJ/MTL/texture loading, the
preprocess (bbox centre to ``center_w``, uniform scale into
[-scale, scale]), ``get_ray_intersection`` (barycentric weights
(1-u-v, u, v), wrap-mode bilinear texture fetch at pixel centres,
vertex-normal interpolation, miss -> zero normal, flip toward the ray
origin), the tiled z-buffer rasterizer, ``get_rgbd_image`` (ray cast or
z-buffer; the RGBDImage's tensors lie on the camera's device) and
``sample_point_cloud``: ``uniform``, ``uniform_quantized`` (round(xyz *
scale) + offset, unique dedup), ``poisson_disk`` (weighted sample
elimination of 5x uniform candidates, ``native/sample_elim.cpp``) and
``uniform_camera`` (26 look-at cameras on a sphere, ray cast on the host,
unprojected on ``device``), and ``remesh`` / ``remesh_file``: a per-face
uv atlas.
"""

from __future__ import annotations

import os
import typing as T

import numpy as np
import torch

from .camera import Camera, derive_camera_intrinsics
from .pointcloud import PointCloud
from .ray import Ray

# --------------------------------------------------------------------------
# texture sampling (plib/uv_mapping.py UVMap semantics)
# --------------------------------------------------------------------------


def sample_texture(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture sampling with wrap mode and pixel-center alignment:
    y = mod(v,1)·H − 0.5, x = mod(u,1)·W − 0.5 (UVMap.__call__)."""
    h, w = texture.shape[:2]
    uv = np.mod(uv, 1.0)
    y = uv[..., 1] * h - 0.5
    x = uv[..., 0] * w - 0.5
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]

    def at(yy, xx):
        return texture[np.mod(yy, h), np.mod(xx, w)]

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def clean_mesh_uv(triangle_uvs: np.ndarray) -> np.ndarray:
    """(F, 3, 2): wrap to [0,1); degenerate all-identical-uv triangles get a
    small synthetic patch at the texture center (mesh_utils.py:13-36)."""
    uvs = triangle_uvs.copy()
    same = np.all(uvs[:, 0] == uvs[:, 1], axis=-1) & np.all(
        uvs[:, 0] == uvs[:, 2], axis=-1
    )
    uvs[same, 0] = [0.5, 0.5]
    uvs[same, 1] = [0.5, 0.51]
    uvs[same, 2] = [0.51, 0.5]
    return uvs - np.floor(uvs)


def clean_texture(img: np.ndarray) -> np.ndarray:
    """Gray/alpha textures -> rgb float [0,1] (mesh_utils.py:39-68)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32)


# --------------------------------------------------------------------------
# OBJ loading (replaces o3d.io.read_triangle_mesh for the benchmark path)
# --------------------------------------------------------------------------


def load_obj(path: str, flip_texture_v: bool = True):
    """Minimal OBJ+MTL loader: v/vt/vn/f (+usemtl with map_Kd or Kd).

    Returns dict with vertices (V,3), triangles (F,3), triangle_uvs
    (F,3,2) or None, vertex_normals (V,3) or None, textures [list of
    (h,w,3) float], material_ids (F,).
    """
    verts, uvs, norms = [], [], []
    faces = []  # (vidx3, vtidx3, vnidx3, mat)
    materials: T.List[np.ndarray] = []
    mat_index: T.Dict[str, int] = {}
    cur_mat = -1
    mtl_colors: T.Dict[str, T.Optional[np.ndarray]] = {}

    def load_mtl(mtl_path):
        if not os.path.exists(mtl_path):
            return
        name = None
        with open(mtl_path, errors="replace") as f:
            mtl_lines = f.readlines()
        for line in mtl_lines:
            ps = line.split()
            if not ps:
                continue
            if ps[0] == "newmtl":
                name = ps[1]
                mtl_colors[name] = None
            elif ps[0] == "Kd" and name:
                if mtl_colors.get(name) is None:
                    c = np.array([float(x) for x in ps[1:4]], np.float32)
                    mtl_colors[name] = np.tile(c, (2, 2, 1))
            elif ps[0] == "map_Kd" and name:
                tex_path = os.path.join(os.path.dirname(mtl_path), ps[-1])
                if os.path.exists(tex_path):
                    from ..io.image import read_png

                    img = clean_texture(read_png(tex_path))
                    if flip_texture_v:
                        img = img[::-1].copy()
                    mtl_colors[name] = img

    base = os.path.dirname(path)
    with open(path, errors="replace") as f:
        obj_lines = f.readlines()
    for line in obj_lines:
        ps = line.split()
        if not ps:
            continue
        if ps[0] == "v":
            verts.append([float(x) for x in ps[1:4]])
        elif ps[0] == "vt":
            uvs.append([float(ps[1]), float(ps[2])])
        elif ps[0] == "vn":
            norms.append([float(x) for x in ps[1:4]])
        elif ps[0] == "mtllib":
            load_mtl(os.path.join(base, " ".join(ps[1:])))
        elif ps[0] == "usemtl":
            nm = ps[1]
            if nm not in mat_index:
                mat_index[nm] = len(materials)
                tex = mtl_colors.get(nm)
                materials.append(
                    tex if tex is not None else np.ones((2, 2, 3), np.float32)
                )
            cur_mat = mat_index[nm]
        elif ps[0] == "f":
            corner = []
            for p in ps[1:]:
                comp = p.split("/")
                vi = int(comp[0])
                ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
                corner.append((vi, ti, ni))
            for k in range(1, len(corner) - 1):  # fan triangulation
                faces.append((corner[0], corner[k], corner[k + 1], cur_mat))

    V = np.asarray(verts, np.float32)
    nf = len(faces)
    tris = np.zeros((nf, 3), np.int32)
    tri_uvs = np.zeros((nf, 3, 2), np.float32) if uvs else None
    tri_ns = np.zeros((nf, 3), np.int32) if norms else None
    mats = np.zeros((nf,), np.int32)
    has_uv = has_n = False
    for i, (a, b, c, m) in enumerate(faces):
        for j, (vi, ti, ni) in enumerate((a, b, c)):
            tris[i, j] = vi - 1 if vi > 0 else len(V) + vi
            if uvs and ti:
                tri_uvs[i, j] = uvs[ti - 1 if ti > 0 else len(uvs) + ti]
                has_uv = True
            if norms and ni:
                tri_ns[i, j] = ni - 1 if ni > 0 else len(norms) + ni
                has_n = True
        mats[i] = max(m, 0)

    vertex_normals = None
    if has_n:
        # map per-corner normals to a per-vertex average
        vertex_normals = np.zeros((len(V), 3), np.float32)
        np.add.at(vertex_normals, tris.reshape(-1),
                  np.asarray(norms, np.float32)[tri_ns.reshape(-1)])
        norms_len = np.linalg.norm(vertex_normals, axis=-1, keepdims=True)
        vertex_normals = vertex_normals / np.maximum(norms_len, 1e-12)
    return {
        "vertices": V,
        "triangles": tris,
        "triangle_uvs": tri_uvs if has_uv else None,
        "vertex_normals": vertex_normals,
        "textures": materials or [np.ones((2, 2, 3), np.float32)],
        "material_ids": mats,
    }


def compute_vertex_normals(vertices, triangles):
    """Area-weighted vertex normals."""
    v0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0
    fn = np.cross(e1, e2)
    vn = np.zeros_like(vertices)
    for j in range(3):
        np.add.at(vn, triangles[:, j], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


# --------------------------------------------------------------------------
# Mesh
# --------------------------------------------------------------------------


class Mesh:
    def __init__(
        self,
        mesh_or_path,
        scale: T.Optional[float] = 1.0,
        center_w=(0.0, 0.0, 0.0),
        clean: bool = True,
    ):
        if isinstance(mesh_or_path, str):
            if mesh_or_path.lower().endswith(".obj"):
                d = load_obj(mesh_or_path)
            else:
                raise NotImplementedError(
                    "mesh loading supports .obj; got " + mesh_or_path
                )
        else:
            d = dict(mesh_or_path)
        self.vertices = np.asarray(d["vertices"], np.float32)
        self.triangles = np.asarray(d["triangles"], np.int32)
        self.triangle_uvs = d.get("triangle_uvs")
        self.vertex_normals = d.get("vertex_normals")
        self.textures = [clean_texture(t) for t in d.get("textures", [])]
        self.material_ids = d.get(
            "material_ids", np.zeros((len(self.triangles),), np.int32)
        )

        # preprocess (mesh_utils.preprocess_mesh)
        if center_w is not None and len(self.vertices):
            lo, hi = self.vertices.min(0), self.vertices.max(0)
            self.vertices = self.vertices + (
                np.asarray(center_w, np.float32) - (lo + hi) / 2.0
            )
        if scale is not None and len(self.vertices):
            lo, hi = self.vertices.min(0), self.vertices.max(0)
            s = np.max((hi - lo) / 2.0)
            if s > 0:
                self.vertices = self.vertices * (scale / s)
        if clean and self.triangle_uvs is not None:
            self.triangle_uvs = clean_mesh_uv(self.triangle_uvs)

        if self.vertex_normals is None and len(self.vertices):
            self.vertex_normals = compute_vertex_normals(
                self.vertices, self.triangles
            )

        # cast(origins, dirs) -> (t, prim, u, v); built at the first cast
        self._caster = None

    # ---- ray casting -----------------------------------------------------

    def _cast(self, origins, dirs):
        if self._caster is None:
            from ..native_bindings import make_caster

            self._caster = make_caster(self.vertices, self.triangles)
        return self._caster(origins, dirs)

    def get_ray_intersection(self, ray: Ray) -> dict:
        """Returns dict(ray_rgbs, ray_ts, surface_normals_w, hit_map) as
        numpy arrays shaped (b, *m, ·)."""
        o = ray.origins_w.detach().cpu().numpy().astype(np.float32)
        d = ray.directions_w.detach().cpu().numpy().astype(np.float32)
        shape = o.shape[:-1]
        t, prim, u, v = self._cast(o.reshape(-1, 3), d.reshape(-1, 3))
        hit = np.isfinite(t)
        prim_safe = np.where(hit, prim, 0)
        bary = np.stack([1 - u - v, u, v], axis=-1)  # (R, 3)
        rgb, normals = self._interp_attributes(
            prim_safe, bary, hit, d.reshape(-1, 3)
        )

        return {
            "ray_rgbs": rgb.reshape(*shape, 3),
            "ray_ts": t.reshape(shape),
            "surface_normals_w": normals.reshape(*shape, 3),
            "hit_map": hit.astype(np.float32).reshape(shape),
        }

    def _interp_attributes(self, prim_safe, bary, hit, dirs_flat):
        """Shared fragment shading for ray-cast and raster hits: texture-uv
        rgb interp (plib/render.py:96-180), vertex-normal interp
        (plib/render.py:183-223), normal flip toward the viewer
        (structures.py:3777-3780)."""
        n = len(prim_safe)
        if self.triangle_uvs is not None and self.textures:
            vert_uv = self.triangle_uvs[prim_safe]  # (R, 3, 2)
            uvq = np.sum(bary[..., None] * vert_uv, axis=-2)  # (R, 2)
            mats = self.material_ids[prim_safe]
            rgb = np.zeros((n, 3), np.float32)
            for mid, tex in enumerate(self.textures):
                sel = mats == mid
                if sel.any():
                    rgb[sel] = sample_texture(tex, uvq[sel])
            rgb *= hit[:, None]
        else:
            rgb = np.ones((n, 3), np.float32) * hit[:, None]

        vn = self.vertex_normals[self.triangles[prim_safe]]  # (R, 3, 3)
        normals = np.sum(bary[..., None] * vn, axis=-2)
        normals *= hit[:, None]
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = np.divide(normals, norm, out=np.zeros_like(normals),
                            where=norm != 0)
        normals = normals * (
            -1 * np.sign(np.sum(normals * dirs_flat, axis=-1, keepdims=True))
        )
        return rgb, normals

    # ---- offscreen z-buffer rasterization ----------------------------------

    def _rasterize_view(self, H_w2c, K, width, height, tile: int = 32,
                        znear: float = 1e-4):
        """Tiled z-buffer triangle rasterizer for one view, in numpy on the
        host (ground-truth frames without ray casting). Ties between
        candidates go to the first (``np.argmin``).

        Perspective-correct barycentrics; pixel centers at (+0.5, +0.5)
        matching generate_camera_rays. Triangles with any vertex closer
        than ``znear`` are dropped (no near-plane clipping — GT cameras
        never slice the object). Returns (prim, bary, zbuf, hit) with
        shapes (H, W), (H, W, 3), (H, W), (H, W)."""
        V = self.vertices
        Tr = self.triangles
        Xc = V @ H_w2c[:3, :3].T + H_w2c[:3, 3]  # (Nv, 3) camera coords
        tv = Xc[Tr]  # (F, 3, 3)
        z = tv[..., 2]
        ok = np.all(z > znear, axis=-1)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        su = fx * tv[..., 0] / z + cx  # (F, 3) screen u
        sv = fy * tv[..., 1] / z + cy
        invz = 1.0 / z

        # signed double-area in screen space; cull degenerates
        area = (su[:, 1] - su[:, 0]) * (sv[:, 2] - sv[:, 0]) - (
            su[:, 2] - su[:, 0]
        ) * (sv[:, 1] - sv[:, 0])
        ok &= np.abs(area) > 1e-12

        prim = np.full((height, width), -1, np.int32)
        zbuf = np.full((height, width), np.inf, np.float32)
        bary = np.zeros((height, width, 3), np.float32)
        fid_all = np.where(ok)[0]
        if len(fid_all) == 0:
            return prim, bary, zbuf, prim >= 0

        # tile binning: a triangle lands in every tile its bbox touches
        u0 = np.clip(np.floor(su[fid_all].min(1) - 0.5), 0, width - 1)
        u1 = np.clip(np.ceil(su[fid_all].max(1) - 0.5), 0, width - 1)
        v0 = np.clip(np.floor(sv[fid_all].min(1) - 0.5), 0, height - 1)
        v1 = np.clip(np.ceil(sv[fid_all].max(1) - 0.5), 0, height - 1)
        tx0, tx1 = (u0 // tile).astype(int), (u1 // tile).astype(int)
        ty0, ty1 = (v0 // tile).astype(int), (v1 // tile).astype(int)

        for ty in range((height + tile - 1) // tile):
            rsel = (ty0 <= ty) & (ty <= ty1)
            if not rsel.any():
                continue
            for tx in range((width + tile - 1) // tile):
                sel = rsel & (tx0 <= tx) & (tx <= tx1)
                if not sel.any():
                    continue
                f = fid_all[sel]  # (n,) candidate triangles
                px0, py0 = tx * tile, ty * tile
                tw = min(tile, width - px0)
                th = min(tile, height - py0)
                pu = (np.arange(tw) + px0 + 0.5)[None, None, :]  # centers
                pv = (np.arange(th) + py0 + 0.5)[None, :, None]
                # edge functions vs each triangle edge -> screen bary
                au, av = su[f][:, :, None, None], sv[f][:, :, None, None]
                w0 = (au[:, 1] - pu) * (av[:, 2] - pv) - (au[:, 2] - pu) * (
                    av[:, 1] - pv
                )
                w1 = (au[:, 2] - pu) * (av[:, 0] - pv) - (au[:, 0] - pu) * (
                    av[:, 2] - pv
                )
                w2 = (au[:, 0] - pu) * (av[:, 1] - pv) - (au[:, 1] - pu) * (
                    av[:, 0] - pv
                )
                ar = area[f][:, None, None]
                l0, l1, l2 = w0 / ar, w1 / ar, w2 / ar  # (n, th, tw)
                inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                # perspective-correct: 1/z interpolates linearly in screen
                iz = (
                    l0 * invz[f][:, 0, None, None]
                    + l1 * invz[f][:, 1, None, None]
                    + l2 * invz[f][:, 2, None, None]
                )
                zf = np.where(inside & (iz > 0), 1.0 / np.maximum(iz, 1e-12),
                              np.inf)
                k = np.argmin(zf, axis=0)  # (th, tw) best candidate
                ij = np.ogrid[:th, :tw]
                zbest = zf[k, ij[0], ij[1]]
                upd = zbest < zbuf[py0:py0 + th, px0:px0 + tw]
                if not upd.any():
                    continue
                izk = np.maximum(iz[k, ij[0], ij[1]], 1e-12)
                bt = np.stack(
                    [
                        (l[k, ij[0], ij[1]] * invz[f][k, i]) / izk
                        for i, l in enumerate((l0, l1, l2))
                    ],
                    axis=-1,
                )  # world-space barycentrics (n/z trick)
                sl = (slice(py0, py0 + th), slice(px0, px0 + tw))
                zbuf[sl] = np.where(upd, zbest, zbuf[sl])
                prim[sl] = np.where(upd, f[k], prim[sl])
                bary[sl] = np.where(upd[..., None], bt, bary[sl])
        return prim, bary, zbuf, prim >= 0

    def _rasterize_rendering(self, camera: Camera):
        """RGBD through the z-buffer rasterizer: the same outputs as the
        ray-cast method. Returns an RGBDImage (b, q, h, w, ·) on the
        camera's device."""
        H_c2w = camera.H_c2w.detach().cpu().numpy().astype(np.float32)
        Ks = camera.intrinsic.detach().cpu().numpy().astype(np.float32)
        b, q = H_c2w.shape[:2]
        Hpx, Wpx = camera.height_px, camera.width_px
        _, d = camera.generate_camera_rays(subsample=1, offsets="center")
        d = d.detach().cpu().numpy().astype(np.float32)  # the normal flip

        rgbs = np.zeros((b, q, Hpx, Wpx, 3), np.float32)
        depths = np.full((b, q, Hpx, Wpx), np.inf, np.float32)
        normals = np.zeros((b, q, Hpx, Wpx, 3), np.float32)
        hits = np.zeros((b, q, Hpx, Wpx), np.float32)
        for ib in range(b):
            for iq in range(q):
                H_w2c = np.linalg.inv(H_c2w[ib, iq])
                prim, bary, zbuf, hit = self._rasterize_view(
                    H_w2c, Ks[ib, iq], Wpx, Hpx)
                prim_safe = np.where(hit, prim, 0).reshape(-1)
                rgb, nrm = self._interp_attributes(
                    prim_safe, bary.reshape(-1, 3), hit.reshape(-1),
                    d[ib, iq].reshape(-1, 3))
                rgbs[ib, iq] = rgb.reshape(Hpx, Wpx, 3)
                normals[ib, iq] = nrm.reshape(Hpx, Wpx, 3)
                depths[ib, iq] = zbuf
                hits[ib, iq] = hit.astype(np.float32)
        return _rgbd(camera, rgbs, depths, normals, hits)

    def get_rgbd_image(self, camera: Camera, render_method: str = "ray_cast"):
        """RGBDImage of the mesh from ``camera``: 'ray_cast' (the BVH, one
        ray per pixel center; depth is the z-depth t * (d . z_cam)) or
        'rasterization' (the z-buffer). inf depth where nothing was hit."""
        if render_method == "rasterization":
            return self._rasterize_rendering(camera)
        if render_method != "ray_cast":
            raise NotImplementedError(render_method)
        o, d = camera.generate_camera_rays(subsample=1, offsets="center")
        res = self.get_ray_intersection(Ray(origins_w=o, directions_w=d))
        zaxis = camera.H_c2w.detach().cpu().numpy()[..., :3, 2]  # (b, q, 3)
        dirs = d.detach().cpu().numpy()
        cosz = np.sum(dirs * zaxis[:, :, None, None, :], axis=-1)
        z = np.where(np.isfinite(res["ray_ts"]), res["ray_ts"] * cosz, np.inf)
        return _rgbd(camera, res["ray_rgbs"], z, res["surface_normals_w"],
                     res["hit_map"])

    # ---- sampling ----------------------------------------------------------

    def _sample_uniform(self, num_points: int, rng) -> T.Tuple[np.ndarray, ...]:
        v0 = self.vertices[self.triangles[:, 0]]
        e1 = self.vertices[self.triangles[:, 1]] - v0
        e2 = self.vertices[self.triangles[:, 2]] - v0
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        p = area / area.sum()
        tri = rng.choice(len(area), size=num_points, p=p)
        r1 = rng.rand(num_points)
        r2 = rng.rand(num_points)
        # standard uniform barycentric sampling
        a = 1 - np.sqrt(r1)
        b = np.sqrt(r1) * (1 - r2)
        c = 1 - a - b
        xyz = (
            a[:, None] * self.vertices[self.triangles[tri, 0]]
            + b[:, None] * self.vertices[self.triangles[tri, 1]]
            + c[:, None] * self.vertices[self.triangles[tri, 2]]
        )
        bary = np.stack([a, b, c], axis=-1)
        if self.triangle_uvs is not None and self.textures:
            uvq = np.sum(bary[..., None] * self.triangle_uvs[tri], axis=-2)
            mats = self.material_ids[tri]
            rgb = np.zeros((num_points, 3), np.float32)
            for mid, tex in enumerate(self.textures):
                sel = mats == mid
                if sel.any():
                    rgb[sel] = sample_texture(tex, uvq[sel])
        else:
            rgb = np.ones((num_points, 3), np.float32)
        vn = self.vertex_normals[self.triangles[tri]]
        nrm = np.sum(bary[..., None] * vn, axis=-2)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        return xyz.astype(np.float32), rgb, nrm.astype(np.float32)

    def sample_point_cloud(
        self, num_points: int, method: str = "poisson_disk", seed: int = 0,
        quantize_scale: float = 448.0, quantize_offset: float = 512.0,
        device=None,
    ) -> PointCloud:
        """A point cloud on ``device`` sampled from the surface with
        ``np.random.RandomState(seed)`` (``uniform_camera``: a Latin
        hypercube of that seed)."""
        rng = np.random.RandomState(seed)
        if method == "uniform":
            xyz, rgb, nrm = self._sample_uniform(num_points, rng)
        elif method == "uniform_quantized":
            # quantize then dedup
            xyz, rgb, nrm = self._sample_uniform(num_points, rng)
            q = np.round(xyz * quantize_scale) + quantize_offset
            # int64 keys: float32 packing collides above 2^24
            qi = q.astype(np.int64)
            _, idx = np.unique(
                (qi[:, 0] * 2048 + qi[:, 1]) * 2048 + qi[:, 2],
                return_index=True,
            )
            xyz, rgb, nrm = q[idx], rgb[idx], nrm[idx]
        elif method == "poisson_disk":
            # weighted sample elimination of 5x candidates (Open3D's
            # sample_points_poisson_disk with init_factor 5)
            from ..native_bindings import sample_elimination

            xyz, rgb, nrm = self._sample_uniform(num_points * 5, rng)
            v0 = self.vertices[self.triangles[:, 0]]
            e1 = self.vertices[self.triangles[:, 1]] - v0
            e2 = self.vertices[self.triangles[:, 2]] - v0
            area = 0.5 * float(
                np.sum(np.linalg.norm(np.cross(e1, e2), axis=-1)))
            r_max = np.sqrt(area / (2.0 * np.sqrt(3.0) * max(num_points, 1)))
            idx = sample_elimination(xyz, num_points, float(r_max))
            xyz, rgb, nrm = xyz[idx], rgb[idx], nrm[idx]
        elif method == "uniform_camera":
            return self._sample_uniform_camera(num_points, seed, device)
        else:
            raise NotImplementedError(method)
        return PointCloud.from_numpy(xyz, rgb, nrm, device=device)

    def _sample_uniform_camera(self, num_points: int, seed: int, device):
        """26 cameras at radius 2.5 looking at the origin (a Latin
        hypercube over the sphere), each side x side pixels at 60 degrees
        with side = ceil(sqrt(num_points / 26 / 0.3)): their hits, ray cast
        on the host and unprojected on ``device``, with a valid mask."""
        from scipy.stats import qmc

        from ..utils import rigid_motion

        n_cams = 26
        side = int(np.ceil(np.sqrt(num_points / n_cams / 0.3)))
        sph = qmc.LatinHypercube(d=2, seed=seed).random(n=n_cams)
        theta = sph[:, 0] * 2 * np.pi
        phi = np.arccos(1 - 2 * sph[:, 1])
        r = 2.5
        eyes = np.stack([r * np.sin(phi) * np.cos(theta),
                         r * np.sin(phi) * np.sin(theta),
                         r * np.cos(phi)], axis=-1).astype(np.float32)
        H = rigid_motion.get_H_c2w_lookat(
            torch.as_tensor(eyes, device=device),
            torch.zeros((n_cams, 3), device=device),
            torch.tensor([[0.0, 1.0, 0.0]], device=device).expand(n_cams, 3))
        K = derive_camera_intrinsics(side, side, 60.0, device=device)
        cam = Camera(H_c2w=H[None], intrinsic=K.expand(1, n_cams, 3, 3),
                     width_px=side, height_px=side)
        return self.get_rgbd_image(cam).get_pcd()


def _rgbd(camera: Camera, rgb, depth, normal_w, hit_map):
    """RGBDImage of host arrays, moved to the camera's device."""
    from .rgbd_image import RGBDImage

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=camera.device)

    return RGBDImage(rgb=dev(rgb), depth=dev(depth), camera=camera,
                     normal_w=dev(normal_w), hit_map=dev(hit_map))


def remesh(mesh: Mesh, atlas_cols: T.Optional[int] = None,
           margin: float = 0.1) -> Mesh:
    """Give every triangle a chart of its own, packed on a square grid of
    atlas cells: each triangle keeps its 2D shape up to uniform scale,
    inset by ``margin`` of its cell (a per-face atlas in place of
    xatlas's unwrapping; valid for texture baking).

    Vectorised over triangles with the JAX package's per-triangle float32
    operations: elementwise ufuncs give the same values on arrays as on
    one triangle, and the length-3 dot products (the norms included) stay
    one ``@`` per row, the BLAS call the JAX loop makes. So the uvs are
    the same bit for bit."""
    import math

    f = len(mesh.triangles)
    cols = atlas_cols or int(math.ceil(math.sqrt(max(f, 1))))
    rows = int(math.ceil(f / max(cols, 1)))
    cell_w, cell_h = 1.0 / cols, 1.0 / rows

    v = mesh.vertices
    t = mesh.triangles
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    e1 = b - a
    e2 = c - a
    n = np.cross(e1, e2)
    y = np.cross(n, e1)
    nrm_e1 = np.sqrt(np.array([r @ r for r in e1], e1.dtype))
    x_axis = e1 / (nrm_e1 + 1e-12)[:, None]
    nrm_y = np.sqrt(np.array([r @ r for r in y], y.dtype))
    y_axis = y / (nrm_y + 1e-12)[:, None]
    p2 = np.zeros((f, 3, 2))
    for i in range(f):
        p2[i, 1] = (e1[i] @ x_axis[i], e1[i] @ y_axis[i])
        p2[i, 2] = (e2[i] @ x_axis[i], e2[i] @ y_axis[i])
    lo = p2.min(axis=1)
    span = np.maximum((p2.max(axis=1) - lo).max(axis=1), 1e-12)
    p2 = (p2 - lo[:, None]) / span[:, None, None]  # fit into the unit square
    idx = np.arange(f)
    corner = np.stack([idx % cols, idx // cols], axis=-1)[:, None]
    tri_uvs = ((corner + margin + p2 * (1 - 2 * margin))
               * np.array([cell_w, cell_h])).astype(np.float32)

    out = Mesh.__new__(Mesh)
    out.vertices = mesh.vertices.copy()
    out.triangles = mesh.triangles.copy()
    out.triangle_uvs = tri_uvs
    out.vertex_normals = mesh.vertex_normals
    out.textures = mesh.textures
    out.material_ids = mesh.material_ids
    out._caster = None
    return out


def remesh_file(obj_in: str, obj_out: str) -> str:
    """Load an OBJ as it is (no centring, scaling or uv cleaning), give it
    the per-face atlas of ``remesh`` and write it as ``v`` / ``vt`` /
    ``f v/vt`` lines, uvs rounded to 6 decimals, numbered by first use and
    shared where equal. Returns ``obj_out``."""
    mesh = Mesh(obj_in, scale=None, center_w=None, clean=False)
    out = remesh(mesh)
    uvs = np.round(out.triangle_uvs, 6)  # float32, as each uv in JAX
    keys = uvs.tolist()
    with open(obj_out, "w") as fh:
        for p in out.vertices:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        uv_idx = {}
        lines = []
        for i, tri in enumerate(out.triangles.tolist()):
            idxs = []
            for j in range(3):
                key = tuple(keys[i][j])
                if key not in uv_idx:
                    uv_idx[key] = len(uv_idx) + 1
                    fh.write(f"vt {uvs[i, j, 0]} {uvs[i, j, 1]}\n")
                idxs.append((tri[j] + 1, uv_idx[key]))
            lines.append("f " + " ".join(f"{a}/{b}" for a, b in idxs) + "\n")
        fh.writelines(lines)
    return obj_out

"""ctypes bindings of the repo's native C++ sources, all but one with a
Python version (the port's own copy of what it needs from
``gpcr_tpu/native_bindings``):

- ``native/raytracer.cpp``: the BVH ray caster (``make_caster``;
  ``numpy_cast`` is its brute-force version);
- ``native/ply_parser.cpp``: the binary PLY reader (``read_ply_native``;
  ``io/ply.py`` is its Python version, and reads what it declines:
  ASCII files and list properties);
- ``native/sample_elim.cpp``: weighted sample elimination
  (``sample_elimination``; ``_sample_elimination_numpy`` is its version
  in numpy and heapq);
- ``native/pr_query.cpp``: the grid-accelerated k-nearest-points-to-ray
  query (``GridRayQuery``). It has no Python version, as in JAX:
  ``utils.geometry.get_k_neighbor_points`` is the brute-force search it
  accelerates, and ``GridRayQuery`` raises without g++ or its source.

Each source is compiled on demand with g++ into
``gpcr_tpu_torch/build/lib<name>.so``. Without g++ or without the source
the callers use the Python version where there is one; ``make_caster`` prints once which
caster is in use. A build that was attempted and failed raises with the
compiler's output: the Python versions are no silent stand-in at the
sizes the native code exists for.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import typing as T

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(os.path.dirname(_PKG), "native")
_SRC = os.path.join(_NATIVE, "raytracer.cpp")
_PLY_SRC = os.path.join(_NATIVE, "ply_parser.cpp")
_SE_SRC = os.path.join(_NATIVE, "sample_elim.cpp")
_PR_SRC = os.path.join(_NATIVE, "pr_query.cpp")
_BUILD = os.path.join(_PKG, "build")
_LOCK = threading.Lock()
_CACHE: dict = {}

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _build(src: str, name: str):
    """Path of ``lib<name>.so`` built from ``src``, or None without g++ or
    without the source; raises when the compiler fails."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.isfile(src):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(
        [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", src,
         "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({r.returncode}) building {src}:\n"
            f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load(key: str, src: str, name: str, declare):
    """The library ``key``, built and loaded once (``declare`` sets its
    functions' argtypes / restype), or None without g++ or the source."""
    with _LOCK:
        if key not in _CACHE:
            path = _build(src, name)
            lib = None if path is None else ctypes.CDLL(path)
            if lib is not None:
                declare(lib)
            _CACHE[key] = lib
        return _CACHE[key]


def _declare_rt(lib):
    lib.rt_build.restype = ctypes.c_void_p
    lib.rt_build.argtypes = [_FP, ctypes.c_int, _IP, ctypes.c_int]
    lib.rt_cast.restype = None
    lib.rt_cast.argtypes = [
        ctypes.c_void_p, _FP, _FP, ctypes.c_long, _FP, _IP, _FP, _FP]
    lib.rt_free.restype = None
    lib.rt_free.argtypes = [ctypes.c_void_p]


def get_raytracer():
    """The loaded ray-caster library, or None when there is no g++ or no
    source to build it from. A failed build or load raises."""
    return _load("rt", _SRC, "gpcr_rt", _declare_rt)


class NativeRaycaster:
    """Owns a built BVH over one triangle mesh."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        self.lib = get_raytracer()
        if self.lib is None:
            raise RuntimeError("native raytracer unavailable")
        # the library reads these buffers for the BVH's lifetime
        self._verts = np.ascontiguousarray(vertices, np.float32)
        self._tris = np.ascontiguousarray(triangles, np.int32)
        self.handle = self.lib.rt_build(
            self._verts.ctypes.data_as(_FP), len(self._verts),
            self._tris.ctypes.data_as(_IP), len(self._tris),
        )

    def cast(self, origins: np.ndarray, dirs: np.ndarray):
        """origins/dirs: (R, 3). Returns (t (R,), prim (R,), u (R,), v (R,))
        with t=inf / prim=-1 on miss; (u, v) Moller-Trumbore barycentrics of
        vertices 1 and 2."""
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        if o.shape != d.shape or o.ndim != 2 or o.shape[1] != 3:
            raise ValueError(f"rays must be (R, 3), got {o.shape}, {d.shape}")
        n = len(o)
        t = np.empty(n, np.float32)
        prim = np.empty(n, np.int32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        self.lib.rt_cast(
            ctypes.c_void_p(self.handle), o.ctypes.data_as(_FP),
            d.ctypes.data_as(_FP), n, t.ctypes.data_as(_FP),
            prim.ctypes.data_as(_IP), u.ctypes.data_as(_FP),
            v.ctypes.data_as(_FP),
        )
        return t, prim, u, v

    def close(self):
        if self.handle:
            self.lib.rt_free(ctypes.c_void_p(self.handle))
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None) and self.lib is not None:
            self.close()


def numpy_cast(vertices, triangles, origins, dirs, chunk=4096):
    """Brute-force Moller-Trumbore fallback (small meshes / no toolchain)."""
    v0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0
    n = len(origins)
    out_t = np.full(n, np.inf, np.float32)
    out_p = np.full(n, -1, np.int32)
    out_u = np.zeros(n, np.float32)
    out_v = np.zeros(n, np.float32)
    for s in range(0, n, chunk):
        o = origins[s : s + chunk, None, :]
        d = dirs[s : s + chunk, None, :]
        p = np.cross(d, e2[None])
        det = np.sum(e1[None] * p, -1)
        safe = np.abs(det) > 1e-12
        inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
        tv = o - v0[None]
        u = np.sum(tv * p, -1) * inv
        q = np.cross(tv, e1[None])
        v = np.sum(d * q, -1) * inv
        t = np.sum(e2[None] * q, -1) * inv
        ok = safe & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        t = np.where(ok, t, np.inf)
        best = np.argmin(t, axis=1)
        rows = np.arange(t.shape[0])
        bt = t[rows, best]
        hit = np.isfinite(bt)
        sl = slice(s, s + t.shape[0])
        out_t[sl] = bt
        out_p[sl] = np.where(hit, best, -1)
        out_u[sl] = np.where(hit, u[rows, best], 0)
        out_v[sl] = np.where(hit, v[rows, best], 0)
    return out_t, out_p, out_u, out_v


def make_caster(vertices: np.ndarray, triangles: np.ndarray):
    """A ``cast(origins, dirs)`` callable for one mesh: the native BVH when
    it builds, else ``numpy_cast``. Prints once which one is in use."""
    if get_raytracer() is not None:
        caster = NativeRaycaster(vertices, triangles).cast
        name = "native BVH (native/raytracer.cpp)"
    else:
        def caster(origins, dirs):
            return numpy_cast(vertices, triangles, origins, dirs)

        name = "numpy brute force (no g++ or no native/raytracer.cpp)"
    with _LOCK:
        if not _CACHE.get("announced"):
            _CACHE["announced"] = True
            print(f"[raycast] {name}", flush=True)
    return caster


# --------------------------------------------------------------------------
# native PLY reader (native/ply_parser.cpp)
# --------------------------------------------------------------------------


def _declare_ply(lib):
    lib.ply_count.restype = ctypes.c_long
    lib.ply_count.argtypes = [ctypes.c_char_p]
    lib.ply_read.restype = ctypes.c_int
    lib.ply_read.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _FP, _FP, _FP, _IP, _IP]


def get_ply_parser():
    """The loaded PLY parser, or None without g++ or its source."""
    return _load("ply", _PLY_SRC, "gpcr_ply", _declare_ply)


def read_ply_native(path: str) -> T.Optional[T.Dict[str, np.ndarray]]:
    """Binary PLY vertex read: dict with 'xyz' (N, 3) float32 plus 'rgb'
    (uint8 colours scaled to [0, 1]) and 'normal' where present. None when
    the parser is not built (no g++ or source) or declines the file
    (ASCII, list properties, no x/y/z): ``io.ply.read_ply`` then reads it
    in Python."""
    lib = get_ply_parser()
    if lib is None:
        return None
    name = os.fsencode(path)
    n = lib.ply_count(name)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    normal = np.empty((n, 3), np.float32)
    has_rgb, has_normal = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.ply_read(name, n, xyz.ctypes.data_as(_FP),
                      rgb.ctypes.data_as(_FP), normal.ctypes.data_as(_FP),
                      ctypes.byref(has_rgb), ctypes.byref(has_normal))
    if rc != 0:
        return None
    out = {"xyz": xyz}
    if has_rgb.value:
        out["rgb"] = rgb
    if has_normal.value:
        out["normal"] = normal
    return out


# --------------------------------------------------------------------------
# weighted sample elimination (native/sample_elim.cpp)
# --------------------------------------------------------------------------


def _declare_se(lib):
    lib.se_eliminate.restype = None
    lib.se_eliminate.argtypes = [
        _FP, ctypes.c_long, ctypes.c_long, ctypes.c_float, ctypes.c_float,
        _IP]


def get_sample_eliminator():
    """The loaded sample-elimination library, or None without g++ or its
    source."""
    return _load("se", _SE_SRC, "gpcr_se", _declare_se)


def sample_elimination(points: np.ndarray, n: int, r_max: float,
                       alpha: float = 8.0) -> np.ndarray:
    """Weighted sample elimination (Yuksel 2015): reduce an M-point
    candidate set to an n-point Poisson-disk set, the algorithm behind
    Open3D's ``sample_points_poisson_disk``. Returns the survivors'
    indices (n,) int32 in ascending order. The native library where it
    builds, else ``_sample_elimination_numpy`` (the same algorithm)."""
    pts = np.ascontiguousarray(points, np.float32)
    m = len(pts)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (M, 3), got {pts.shape}")
    if n >= m:
        return np.arange(m, dtype=np.int32)
    lib = get_sample_eliminator()
    if lib is None:
        return _sample_elimination_numpy(pts, n, r_max, alpha)
    out = np.empty(n, np.int32)
    lib.se_eliminate(pts.ctypes.data_as(_FP), m, n, ctypes.c_float(r_max),
                     ctypes.c_float(alpha), out.ctypes.data_as(_IP))
    return out


def _sample_elimination_numpy(pts: np.ndarray, n: int, r_max: float,
                              alpha: float) -> np.ndarray:
    """The same algorithm in Python: a grid for the neighbour lists and a
    heapq with lazy deletion."""
    import heapq

    m = len(pts)
    r_e = 2.0 * r_max
    lo = pts.min(0)
    cell = np.maximum(r_e, 1e-12)
    key = np.floor((pts - lo) / cell).astype(np.int64)
    grid: dict = {}
    for i, k in enumerate(map(tuple, key)):
        grid.setdefault(k, []).append(i)

    nbrs: T.List[T.List[int]] = [[] for _ in range(m)]
    w = np.zeros(m)
    for i in range(m):
        kx, ky, kz = key[i]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((kx + dx, ky + dy, kz + dz), ()):
                        if j <= i:
                            continue
                        d = float(np.linalg.norm(pts[i] - pts[j]))
                        if d < r_e:
                            nbrs[i].append(j)
                            nbrs[j].append(i)
                            wij = (1.0 - d / r_e) ** alpha
                            w[i] += wij
                            w[j] += wij

    heap = [(-w[i], i) for i in range(m)]
    heapq.heapify(heap)
    alive = np.ones(m, bool)
    remaining = m
    while remaining > n:
        nw, i = heapq.heappop(heap)
        if not alive[i] or -nw != w[i]:
            if alive[i]:
                heapq.heappush(heap, (-w[i], i))
            continue
        alive[i] = False
        remaining -= 1
        for j in nbrs[i]:
            if alive[j]:
                d = float(np.linalg.norm(pts[i] - pts[j]))
                w[j] -= (1.0 - d / r_e) ** alpha
                heapq.heappush(heap, (-w[j], j))
    return np.nonzero(alive)[0][:n].astype(np.int32)


# --------------------------------------------------------------------------
# k nearest points to rays (native/pr_query.cpp)
# --------------------------------------------------------------------------


def _declare_pr(lib):
    lib.pr_build.restype = ctypes.c_void_p
    lib.pr_build.argtypes = [_FP, ctypes.c_long, ctypes.c_float]
    lib.pr_query.restype = None
    lib.pr_query.argtypes = [
        ctypes.c_void_p, _FP, _FP, ctypes.c_long, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _IP, _FP, _FP]
    lib.pr_free.restype = None
    lib.pr_free.argtypes = [ctypes.c_void_p]


class GridRayQuery:
    """Grid-accelerated k-nearest-points-to-ray query on the host: a
    uniform grid of ``cell_size`` cells that each ray walks with a 3D DDA,
    testing the points of the 3x3x3 cells around each visited cell.
    Raises without g++ or ``native/pr_query.cpp``."""

    def __init__(self, points: np.ndarray, cell_size: float):
        lib = _load("pr", _PR_SRC, "gpcr_pr", _declare_pr)
        if lib is None:
            raise RuntimeError(
                "GridRayQuery needs g++ and native/pr_query.cpp; "
                "utils.geometry.get_k_neighbor_points is the brute force")
        self.lib = lib
        self._pts = np.ascontiguousarray(points, np.float32)
        self.handle = lib.pr_build(self._pts.ctypes.data_as(_FP),
                                   len(self._pts), ctypes.c_float(cell_size))

    def query(self, origins, dirs, k: int, t_min=0.0, t_max=1e10,
              radius=None):
        """Returns (idx (R, k) int32, -1 = miss; dist (R, k); t (R, k)),
        sorted by perpendicular distance, restricted to dist <= radius (no
        limit without one) and t in [t_min, t_max]."""
        o = np.ascontiguousarray(origins, np.float32).reshape(-1, 3)
        d = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        r = len(o)
        idx = np.empty((r, k), np.int32)
        dist = np.empty((r, k), np.float32)
        ts = np.empty((r, k), np.float32)
        self.lib.pr_query(
            ctypes.c_void_p(self.handle), o.ctypes.data_as(_FP),
            d.ctypes.data_as(_FP), r, k, ctypes.c_float(t_min),
            ctypes.c_float(t_max),
            ctypes.c_float(radius if radius is not None else 1e30),
            idx.ctypes.data_as(_IP), dist.ctypes.data_as(_FP),
            ts.ctypes.data_as(_FP))
        return idx, dist, ts

    def close(self):
        if self.handle:
            self.lib.pr_free(ctypes.c_void_p(self.handle))
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()

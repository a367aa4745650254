"""ctypes binding of the repo's native BVH ray caster, plus its numpy
fallback (the port's own copy of what training needs from
``gpcr_tpu/native_bindings``).

``native/raytracer.cpp`` is compiled on demand with g++ into
``gpcr_tpu_torch/build/libgpcr_rt.so``. Without g++ or without the source
callers use ``numpy_cast``; ``make_caster`` picks one and prints once which
caster is in use. A build that was attempted and failed raises with the
compiler's output: the brute-force caster is no silent stand-in at
training sizes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "raytracer.cpp")
_BUILD = os.path.join(_PKG, "build")
_LOCK = threading.Lock()
_CACHE: dict = {}


def _build_raytracer():
    """Path of the built library, or None without g++ or without the
    source; raises when the compiler fails."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.isfile(_SRC):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, "libgpcr_rt.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(
        [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", _SRC,
         "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({r.returncode}) building {_SRC}:\n"
            f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def get_raytracer():
    """The loaded ray-caster library, or None when there is no g++ or no
    source to build it from. A failed build or load raises."""
    with _LOCK:
        if "rt" not in _CACHE:
            path = _build_raytracer()
            lib = None if path is None else ctypes.CDLL(path)
            if lib is not None:
                fp = ctypes.POINTER(ctypes.c_float)
                ip = ctypes.POINTER(ctypes.c_int)
                lib.rt_build.restype = ctypes.c_void_p
                lib.rt_build.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int]
                lib.rt_cast.restype = None
                lib.rt_cast.argtypes = [
                    ctypes.c_void_p, fp, fp, ctypes.c_long, fp, ip, fp, fp]
                lib.rt_free.restype = None
                lib.rt_free.argtypes = [ctypes.c_void_p]
            _CACHE["rt"] = lib
        return _CACHE["rt"]


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
            self._verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(self._verts),
            self._tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(self._tris),
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
        fp = ctypes.POINTER(ctypes.c_float)
        self.lib.rt_cast(
            ctypes.c_void_p(self.handle), o.ctypes.data_as(fp),
            d.ctypes.data_as(fp), n, t.ctypes.data_as(fp),
            prim.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            u.ctypes.data_as(fp), v.ctypes.data_as(fp),
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

"""Build-at-first-use loader for the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``gpcr_tpu_torch/build/lib<name>-<hash>.so``,
then loaded with ``ctypes``. The file name carries a hash of the source,
the ``.cuh`` headers beside it and the flags, so an edited source or header
is rebuilt and a stale library is never loaded. Nothing is built at
import time: the CPU tests import every module on machines without a CUDA
toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

from ..utils import trace

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# -fmad=false: no multiply-add contraction, so the kernels' float32
# arithmetic rounds exactly like their plain PyTorch versions.
# -Xptxas -v: registers, shared memory and spills per kernel, kept beside
# the library (<lib>.so.log) and in BUILD_LOGS for the build report.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_LIBS: dict = {}
BUILD_LOGS: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from gpcr_tpu_torch/csrc at first use")


def load(name: str, csrc_dir: str = CSRC_DIR, defines=()) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc_dir>/<name>.cu``; raises on
    failure. ``defines`` (macro names) select a diagnostic build; each
    (directory, name, defines) is its own library."""
    key = (os.path.abspath(csrc_dir), name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    src = os.path.join(csrc_dir, name + ".cu")
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(" ".join(flags).encode())
    # the source and every header beside it (what it may include)
    for path in [src] + sorted(
            os.path.join(csrc_dir, h) for h in os.listdir(csrc_dir)
            if h.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *flags, "-o", tmp, src]
        with trace.span("gpcr.kernel.build"):
            r = subprocess.run(cmd, capture_output=True, text=True)
        trace.count("kernel_builds", 1)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}) building {src}:\n"
                f"{r.stdout}\n{r.stderr}")
        with open(out + ".log", "w") as f:
            f.write((r.stdout + r.stderr).strip() + "\n")
        os.replace(tmp, out)
    if key == (os.path.abspath(CSRC_DIR), name, ()) and os.path.exists(
            out + ".log"):
        with open(out + ".log") as f:
            BUILD_LOGS[name] = f.read().strip()
    with trace.span("gpcr.kernel.load"):
        lib = ctypes.CDLL(out)
    _LIBS[key] = lib
    return lib


@contextlib.contextmanager
def use_library(name: str, lib: ctypes.CDLL):
    """Within the block, ``load(name)``, which the wrappers call, returns
    ``lib`` in place of the build of ``csrc/<name>.cu``: another build
    with the same C interface (a diagnostic build, another version's
    sources), timed or traced through the production wrappers."""
    key = (os.path.abspath(CSRC_DIR), name, ())
    kept = _LIBS.get(key)
    _LIBS[key] = lib
    try:
        yield lib
    finally:
        if kept is None:
            del _LIBS[key]
        else:
            _LIBS[key] = kept

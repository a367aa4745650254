"""Build-at-first-use loader for the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``gpcr_tpu_torch/build/lib<name>-<hash>.so``,
then loaded with ``ctypes``. The file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built at import time: the CPU tests import every module
on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

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


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}) building {src}:\n"
                f"{r.stdout}\n{r.stderr}")
        with open(out + ".log", "w") as f:
            f.write((r.stdout + r.stderr).strip() + "\n")
        os.replace(tmp, out)
    if os.path.exists(out + ".log"):
        with open(out + ".log") as f:
            BUILD_LOGS[name] = f.read().strip()
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib

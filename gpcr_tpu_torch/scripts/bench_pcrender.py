"""``pcrender`` end-to-end scoreboard on the port at the BASELINE config,
through the real CLI (twin of ``scripts/bench_pcrender.py``). The weights
are random, made from a seed: no trained checkpoint is in the
repository, and the reference's 'model time / rgb time' protocol does not
depend on them.

    python -m gpcr_tpu_torch.scripts.bench_pcrender [--points 800000] \
        [--scale_factor 448] [--device cuda] [--root DIR] [CLI flags ...]

Writes a run directory with the deployed-width ``PCEncoder`` (options in
``option/options.json``, which the port's loader reads first; seeded
weights as a ``.npz`` in the JAX package's layout) and the 800K-point
THuman-like cloud as ``pcd_0.ply``, then runs ``python -m
gpcr_tpu_torch.cli.benchmark pcrender --skip_mesh --voxelized`` in a
subprocess with every flag it does not know itself passed on (e.g.
``--dup_cap 256``: seeded random weights give rects wider than the CLI's
default cap of 16 tiles) and prints the scoreboard lines (the protocol
of simple_raw_render.py:372-379,433-456). ``--root`` defaults to a new
temporary directory.

The JAX script takes the points and the scale factor as positional
arguments; here they are ``--points`` and ``--scale_factor``, so that a
passed-on flag's value is never read as one of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

from ..cli.profile_pcrender import LEARNED_INFO, synthetic_cloud
from . import require_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ASSET_ID = "0519"


def write_inputs(dataset_root: str, run_dir: str, n: int = 800_000,
                 sf: int = 448, seed: int = 0) -> str:
    """Write ``<dataset_root>/0519/pcd_0.ply`` (``synthetic_cloud``: the
    JAX script's draws, noise 0.002, clipped to the grid) and a run
    directory holding ``option/options.json`` and
    ``checkpoint/model_epoch1.npz``, a ``PCEncoder`` at the deployed width
    ``9 32 64 128 256 128`` with weights drawn from ``seed``. Returns the
    checkpoint's path."""
    from ..io import write_ply
    from ..models.encoder import PCEncoder
    from ..render.checkpoint import save_params

    coords, rgb = synthetic_cloud(n, sf, seed=seed)
    ds = os.path.join(dataset_root, ASSET_ID)
    os.makedirs(ds, exist_ok=True)
    write_ply(os.path.join(ds, "pcd_0.ply"), coords, rgb)

    info = dict(LEARNED_INFO, scale_factor=sf)
    os.makedirs(os.path.join(run_dir, "option"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "checkpoint"), exist_ok=True)
    with open(os.path.join(run_dir, "option", "options.json"), "w") as f:
        json.dump({"pcml_info": info}, f)
    ckpt = os.path.join(run_dir, "checkpoint", "model_epoch1.npz")
    save_params(ckpt, PCEncoder(
        info, generator=torch.Generator().manual_seed(seed)))
    return ckpt


def main(argv=None) -> dict:
    """Build the inputs and run the CLI; returns its ``returncode``, the
    scoreboard ``lines`` and the written ``outputs``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=800_000)
    ap.add_argument("--scale_factor", type=int, default=448)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="directory for the inputs and the renders "
                         "(default: a new temporary directory)")
    args, extra = ap.parse_known_args(argv)
    require_device(args.device)
    sf = args.scale_factor
    root = args.root or tempfile.mkdtemp(prefix="pcrender_bench_")
    ckpt = write_inputs(os.path.join(root, "ds"), os.path.join(root, "train"),
                        args.points, sf)
    out = os.path.join(root, "out")
    cmd = [
        sys.executable, "-m", "gpcr_tpu_torch.cli.benchmark", "pcrender",
        "--ckpt", ckpt, "--id_list", ASSET_ID,
        "--dataset_root", os.path.join(root, "ds"), "--rpth", out + "/",
        "--skip_mesh", "--voxelized", "--scale_factor", str(sf),
        "--fov", "45", "--device", args.device,
    ] + extra
    print("running:", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                       cwd=REPO)
    lines = [line for line in r.stdout.splitlines()
             if "time" in line or "Info" in line or "Warn" in line
             or line.startswith("#")]
    for line in lines:
        print(line, flush=True)
    if r.returncode != 0:
        print(r.stderr[-3000:], flush=True)
        return dict(returncode=r.returncode, lines=lines, outputs=[])
    outputs = sorted(os.listdir(out))
    print("outputs:", outputs, flush=True)
    return dict(returncode=0, lines=lines, outputs=outputs)


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["returncode"] == 0 else 1)

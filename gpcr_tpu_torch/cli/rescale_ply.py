"""Voxel <-> world PLY conversion, as a PCC codec round trip needs it
(port of ``gpcr_tpu/cli/rescale_ply.py``): xyz -> (xyz - offset) / factor,
or with ``--inverse`` xyz * factor + offset; colours and normals are
copied.

    python -m gpcr_tpu_torch.cli.rescale_ply in.ply out.ply --factor 448
"""

from __future__ import annotations

import argparse

from ..io import read_ply, write_ply


def rescale(in_path: str, out_path: str, offset: float = 512.0,
            factor: float = 256.0, inverse: bool = False):
    d = read_ply(in_path)
    xyz = d["xyz"]
    if inverse:
        xyz = xyz * factor + offset  # world -> voxel
    else:
        xyz = (xyz - offset) / factor  # voxel -> world
    write_ply(out_path, xyz, rgb=d.get("rgb"), normal=d.get("normal"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--offset", type=float, default=512.0)
    ap.add_argument("--factor", type=float, default=256.0)
    ap.add_argument("--inverse", action="store_true",
                    help="world -> voxel instead of voxel -> world")
    args = ap.parse_args(argv)
    rescale(args.input, args.output, args.offset, args.factor, args.inverse)


if __name__ == "__main__":
    main()

"""File readers and writers of the port.

These are the host-only, numpy-only modules of ``gpcr_tpu.io`` (PLY and
PNG), shared rather than copied: neither imports jax. This module is the
one place in the port that names them; everything else, ``chip_smoke.py``
included, imports them from here.
"""

from gpcr_tpu.io.image import read_png, save_pic, to_uint8, write_png
from gpcr_tpu.io.ply import read_ply, write_ply

__all__ = ["read_png", "save_pic", "to_uint8", "write_png", "read_ply",
           "write_ply"]

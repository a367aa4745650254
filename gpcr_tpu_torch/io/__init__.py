"""File readers and writers of the port: PLY point clouds and PNG images.

The port's own numpy-only modules; nothing here (or anywhere else in
``gpcr_tpu_torch``) imports the JAX package.
"""

from .image import read_png, save_pic, to_uint8, write_png
from .ply import read_ply, write_ply

__all__ = ["read_png", "save_pic", "to_uint8", "write_png", "read_ply",
           "write_ply"]

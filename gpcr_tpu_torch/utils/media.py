"""Media output helpers (port of ``gpcr_tpu/utils/media.py``): gif writer
and reader, mp4 writer, title banners with a 3x5 bitmap font, image
tiling, sRGB conversion.

Everything but the gif / mp4 writers and the gif reader is numpy. Those
import ``imageio`` (and, for an mp4 that imageio has no backend for,
``cv2``) when called: without the package they raise an ImportError that
names it.
"""

from __future__ import annotations

import os
import typing as T

import numpy as np


def _iio():
    try:
        import imageio.v2 as iio
    except ImportError as e:
        raise ImportError(
            "the gif / mp4 writers and the gif reader need the 'imageio' "
            "package, which is not installed") from e
    return iio


def create_gif(
    images: T.Sequence[np.ndarray], filename: str, fps: float = 10.0,
    loop: int = 0,
):
    """Write float [0,1] or uint8 frames to a gif."""
    frames = [_to_u8(f) for f in images]
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    _iio().mimsave(filename, frames, duration=1.0 / fps, loop=loop)


def gif_to_nparray(filename: str) -> np.ndarray:
    """(n, h, w, c) uint8."""
    return np.stack(_iio().mimread(filename), axis=0)


def create_video(
    images: T.Sequence[np.ndarray], filename: str, fps: float = 30.0,
):
    """mp4 writer: imageio's ffmpeg backend, else OpenCV's mp4v writer."""
    frames = [_to_u8(f) for f in images]
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    iio = _iio()
    try:
        iio.mimsave(filename, frames, fps=fps)
        return
    except ValueError:  # imageio has no backend for mp4
        pass
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "create_video needs imageio's ffmpeg backend or the 'cv2' "
            "package (opencv-python); neither is installed") from e
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(filename, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()


def add_title_to_image(
    img: np.ndarray, title: str, banner_height: int = 24,
    color=(255, 255, 255), bg=(0, 0, 0),
) -> np.ndarray:
    """Prepend a text banner drawn with a 3x5 bitmap font (no font
    file)."""
    img = _to_u8(img)
    h, w = img.shape[:2]
    banner = np.zeros((banner_height, w, 3), np.uint8)
    banner[:] = bg
    _draw_text(banner, title[: w // 6], color)
    return np.concatenate([banner, img], axis=0)


def tile_images(
    images: T.Sequence[np.ndarray], n_cols: T.Optional[int] = None,
    pad: int = 2, pad_value: int = 0,
) -> np.ndarray:
    """Tile equal-size images into a grid, ``pad`` pixels apart."""
    imgs = [_to_u8(i) for i in images]
    n = len(imgs)
    if n_cols is None:
        n_cols = int(np.ceil(np.sqrt(n)))
    n_rows = int(np.ceil(n / n_cols))
    h, w = imgs[0].shape[:2]
    out = np.full(
        (n_rows * (h + pad) - pad, n_cols * (w + pad) - pad, 3),
        pad_value, np.uint8,
    )
    for i, im in enumerate(imgs):
        r, c = divmod(i, n_cols)
        out[r * (h + pad) : r * (h + pad) + h,
            c * (w + pad) : c * (w + pad) + w] = im
    return out


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """sRGB [0, 1] -> linear."""
    img = np.asarray(img, np.float32)
    return np.where(
        img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
    )


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * img ** (1 / 2.4) - 0.055
    )


def _to_u8(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        out = img
    else:
        out = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=-1)
    return out


_FONT = {
    # minimal 3x5 uppercase font (bit rows, LSB = left column)
    "A": [0b010, 0b101, 0b111, 0b101, 0b101], "B": [0b011, 0b101, 0b011, 0b101, 0b011],
    "C": [0b110, 0b001, 0b001, 0b001, 0b110], "D": [0b011, 0b101, 0b101, 0b101, 0b011],
    "E": [0b111, 0b001, 0b011, 0b001, 0b111], "F": [0b111, 0b001, 0b011, 0b001, 0b001],
    "G": [0b110, 0b001, 0b101, 0b101, 0b110], "H": [0b101, 0b101, 0b111, 0b101, 0b101],
    "I": [0b111, 0b010, 0b010, 0b010, 0b111], "J": [0b100, 0b100, 0b100, 0b101, 0b010],
    "K": [0b101, 0b011, 0b001, 0b011, 0b101], "L": [0b001, 0b001, 0b001, 0b001, 0b111],
    "M": [0b101, 0b111, 0b111, 0b101, 0b101], "N": [0b101, 0b111, 0b111, 0b111, 0b101],
    "O": [0b010, 0b101, 0b101, 0b101, 0b010], "P": [0b011, 0b101, 0b011, 0b001, 0b001],
    "Q": [0b010, 0b101, 0b101, 0b111, 0b110], "R": [0b011, 0b101, 0b011, 0b101, 0b101],
    "S": [0b110, 0b001, 0b010, 0b100, 0b011], "T": [0b111, 0b010, 0b010, 0b010, 0b010],
    "U": [0b101, 0b101, 0b101, 0b101, 0b111], "V": [0b101, 0b101, 0b101, 0b010, 0b010],
    "W": [0b101, 0b101, 0b111, 0b111, 0b101], "X": [0b101, 0b101, 0b010, 0b101, 0b101],
    "Y": [0b101, 0b101, 0b010, 0b010, 0b010], "Z": [0b111, 0b100, 0b010, 0b001, 0b111],
    "0": [0b010, 0b101, 0b101, 0b101, 0b010], "1": [0b010, 0b011, 0b010, 0b010, 0b111],
    "2": [0b011, 0b100, 0b010, 0b001, 0b111], "3": [0b011, 0b100, 0b010, 0b100, 0b011],
    "4": [0b101, 0b101, 0b111, 0b100, 0b100], "5": [0b111, 0b001, 0b011, 0b100, 0b011],
    "6": [0b110, 0b001, 0b011, 0b101, 0b010], "7": [0b111, 0b100, 0b010, 0b010, 0b010],
    "8": [0b010, 0b101, 0b010, 0b101, 0b010], "9": [0b010, 0b101, 0b110, 0b100, 0b011],
    " ": [0, 0, 0, 0, 0], "-": [0, 0, 0b111, 0, 0], "_": [0, 0, 0, 0, 0b111],
    ".": [0, 0, 0, 0, 0b010], ":": [0, 0b010, 0, 0b010, 0],
    "/": [0b100, 0b100, 0b010, 0b001, 0b001],
}


def _draw_text(img, text, color, scale: int = 2, x0: int = 4, y0: int = 4):
    x = x0
    for ch in text.upper():
        glyph = _FONT.get(ch, _FONT[" "])
        for ry, row in enumerate(glyph):
            for rx in range(3):
                if row >> rx & 1:
                    ys = y0 + ry * scale
                    xs = x + rx * scale
                    img[ys : ys + scale, xs : xs + scale] = color
        x += 4 * scale
        if x + 4 * scale >= img.shape[1]:
            break

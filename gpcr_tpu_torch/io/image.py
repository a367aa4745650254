"""PNG IO and the reference's image-saving conventions (the port's own
copy of ``gpcr_tpu/io/image.py``).

``save_pic`` mirrors the reference exactly (simple_raw_render.py:132-165):
rgb ×255 clamp; normal (n+1)/2 with optional hit-map white compositing;
xyz (x+1)/2; filenames '{type}_{iq}{suffix}.png'. Uses imageio when present,
else a minimal pure-python PNG codec.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:
    import imageio.v2 as _imageio
except ImportError:  # pragma: no cover
    _imageio = None


def write_png(path: str, img: np.ndarray):
    """Write (H, W, 3) or (H, W) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("write_png expects uint8")
    if _imageio is not None:
        _imageio.imwrite(path, img)
        return
    _write_png_pure(path, img)


def read_png(path: str) -> np.ndarray:
    if _imageio is not None:
        return np.asarray(_imageio.imread(path))
    return _read_png_pure(path)


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with the reference's (*255).clamp cast
    (truncation, matching torch .numpy().astype(np.uint8))."""
    return np.clip(np.asarray(img01, np.float32) * 255.0, 0, 255).astype(np.uint8)


def save_pic(img, pth: str, type: str = "rgb", hit_map=None, suffix: str = ""):
    """Save a (b, q, h, w, 3) image batch per the reference conventions
    (simple_raw_render.py:132-165)."""
    os.makedirs(pth, exist_ok=True)
    img = np.asarray(img)
    b, q = img.shape[:2]
    if hit_map is not None:
        hit_map = np.asarray(hit_map)
    for ib in range(b):
        for iq in range(q):
            filename = os.path.join(pth, f"{type}_{iq}{suffix}.png")
            frame = img[ib, iq]
            if type in ("rgb", "shaded"):
                out = frame
            elif type == "normal_w":
                out = (frame + 1.0) / 2.0
                if hit_map is not None:
                    hm = hit_map[ib, iq]
                    out = out * hm + (1.0 - hm)
            elif type == "xyz_w":
                out = (frame + 1.0) / 2.0
            else:
                raise ValueError(type)
            write_png(filename, to_uint8(out))


# ---- minimal pure-python PNG (fallback only) --------------------------------


def _write_png_pure(path: str, img: np.ndarray):
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _read_png_pure(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, meta = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            meta = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color_type = meta[0], meta[1], meta[2], meta[3]
    assert depth == 8, "only 8-bit supported"
    c = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for i in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ft == 1:  # sub
            for j in range(c, stride):
                row[j] = (int(row[j]) + int(row[j - c])) & 0xFF
        elif ft == 2:  # up
            row = (row + prev) & 0xFF
        elif ft == 3:  # average
            for j in range(stride):
                left = row[j - c] if j >= c else 0
                row[j] = (int(row[j]) + ((int(left) + int(prev[j])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for j in range(stride):
                a = int(row[j - c]) if j >= c else 0
                bb = int(prev[j])
                cc = int(prev[j - c]) if j >= c else 0
                p = a + bb - cc
                pa, pb, pc = abs(p - a), abs(p - bb), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (bb if pb <= pc else cc)
                row[j] = (int(row[j]) + pr) & 0xFF
        img[i] = row
        prev = img[i]
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)

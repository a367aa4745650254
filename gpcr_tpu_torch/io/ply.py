"""PLY point-cloud reader/writer (the port's own copy of
``gpcr_tpu/io/ply.py``).

Supports ascii and binary little/big endian, vertex properties x/y/z,
red/green/blue (uint8 or float), nx/ny/nz. ``read_ply`` takes the native
parser (``native/ply_parser.cpp`` through ``native_bindings``) where it is
built and accepts the file; the numpy reader below reads the rest (ASCII,
list properties) and everything when there is no g++.
"""

from __future__ import annotations

import os
import typing as T

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> T.Dict[str, np.ndarray]:
    """Read a PLY file's vertex element.

    Returns dict with 'xyz' (N,3) float32 plus optional 'rgb' (N,3) float32
    in [0,1] and 'normal' (N,3) float32.
    """
    from ..native_bindings import read_ply_native

    out = read_ply_native(path)
    if out is not None:
        return out
    return read_ply_python(path)


def read_ply_python(path: str) -> T.Dict[str, np.ndarray]:
    """``read_ply`` in numpy alone."""
    with open(path, "rb") as f:
        header, fmt, elems = _read_header(f)
        if "vertex" not in elems:
            raise ValueError(f"{path}: no vertex element")
        counts_props = elems  # ordered dict name -> (count, props)
        data = {}
        for name, (count, props) in counts_props.items():
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                arr = np.array(rows, dtype=np.float64) if rows else np.zeros((0, len(props)))
                rec = {p[0]: arr[:, i] for i, p in enumerate(props)}
            else:
                endian = "<" if fmt == "binary_little_endian" else ">"
                dtype = np.dtype([(p[0], endian + _PLY_DTYPES[p[1]]) for p in props])
                raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
                rec = {p[0]: raw[p[0]] for p in props}
            data[name] = rec
    v = data["vertex"]
    out: T.Dict[str, np.ndarray] = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    }
    if all(k in v for k in ("red", "green", "blue")):
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32)
        if rgb.max(initial=0.0) > 1.0 + 1e-6:
            rgb = rgb / 255.0
        out["rgb"] = rgb
    if all(k in v for k in ("nx", "ny", "nz")):
        out["normal"] = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    return out


def write_ply(
    path: str,
    xyz: np.ndarray,
    rgb: T.Optional[np.ndarray] = None,
    normal: T.Optional[np.ndarray] = None,
    binary: bool = True,
    overwrite: bool = True,
):
    """Write a point cloud PLY. rgb expected in [0,1] (stored as uint8)."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)  # overwrite guard, ref structures.py:835
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    header_props = ["property float x", "property float y", "property float z"]
    if normal is not None:
        normal = np.asarray(normal, np.float32).reshape(-1, 3)
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols += [normal[:, 0], normal[:, 1], normal[:, 2]]
        header_props += ["property float nx", "property float ny", "property float nz"]
    if rgb is not None:
        rgb8 = np.clip(np.asarray(rgb, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rgb8 = rgb8.reshape(-1, 3)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [rgb8[:, 0], rgb8[:, 1], rgb8[:, 2]]
        header_props += [
            "property uchar red", "property uchar green", "property uchar blue",
        ]
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        "ply\n"
        f"format {fmt}\n"
        f"element vertex {n}\n" + "\n".join(header_props) + "\nend_header\n"
    )
    rec = np.empty(n, dtype=[(p[0], "<" + p[1]) for p in props])
    for (name, _), col in zip(props, cols):
        rec[name] = col
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(rec.tobytes())
        else:
            np.savetxt(f, np.stack([rec[p[0]].astype(np.float64) for p in props], axis=-1),
                       fmt="%.8g")


def _read_header(f):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elems: "dict[str, tuple[int, list]]" = {}
    cur = None
    header_lines = [line]
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        header_lines.append(line.strip())
        parts = line.decode("ascii", "replace").split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            elems[cur] = (int(parts[2]), [])
        elif parts[0] == "property":
            if parts[1] == "list":
                elems[cur][1].append((parts[4], "list", parts[2], parts[3]))
            else:
                elems[cur][1].append((parts[2], parts[1]))
        elif parts[0] == "end_header":
            break
    return header_lines, fmt, elems

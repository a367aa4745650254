"""OBJ dataset cleaning (port of ``gpcr_tpu/utils/preprocess_obj.py``):
copy obj / mtl / textures into a cleaned tree, give every plain-Kd
material a 2x2 texture of its colour, and remove duplicate faces. Python
and numpy; the textures are written with the port's ``io.image.write_png``
(its own PNG codec where imageio is missing)."""

from __future__ import annotations

import os
import shutil
import typing as T

import numpy as np

from ..io.image import write_png


def preprocess_obj(src_obj: str, dst_dir: str) -> str:
    """Clean one OBJ into dst_dir. Returns the new obj path."""
    os.makedirs(dst_dir, exist_ok=True)
    base = os.path.dirname(src_obj)
    name = os.path.basename(src_obj)
    dst_obj = os.path.join(dst_dir, name)

    mtl_files: T.List[str] = []
    faces_seen = set()
    out_lines: T.List[str] = []
    with open(src_obj, errors="replace") as f:
        src_lines = f.readlines()
    for line in src_lines:
        ps = line.split()
        if not ps:
            out_lines.append(line)
            continue
        if ps[0] == "mtllib":
            mtl_files.append(" ".join(ps[1:]))
            out_lines.append(line)
        elif ps[0] == "f":
            key = tuple(sorted(ps[1:]))
            if key in faces_seen:
                continue  # duplicate face (same corners in any order)
            faces_seen.add(key)
            out_lines.append(line)
        else:
            out_lines.append(line)
    with open(dst_obj, "w") as f:
        f.writelines(out_lines)

    for mtl in mtl_files:
        src_mtl = os.path.join(base, mtl)
        if not os.path.exists(src_mtl):
            continue
        dst_mtl = os.path.join(dst_dir, mtl)
        os.makedirs(os.path.dirname(dst_mtl) or dst_dir, exist_ok=True)
        _clean_mtl(src_mtl, dst_mtl, base, dst_dir)
    return dst_obj


def _clean_mtl(src_mtl: str, dst_mtl: str, src_base: str, dst_dir: str):
    """Copy textures; synthesize a texture for each plain-Kd material."""
    out = []
    cur_mtl = None
    kd: T.Dict[str, T.Tuple[float, float, float]] = {}
    has_map: T.Dict[str, bool] = {}
    with open(src_mtl, errors="replace") as f:
        lines = f.readlines()
    for line in lines:
        ps = line.split()
        if not ps:
            continue
        if ps[0] == "newmtl":
            cur_mtl = ps[1]
            has_map.setdefault(cur_mtl, False)
        elif ps[0] == "Kd" and cur_mtl:
            kd[cur_mtl] = tuple(float(x) for x in ps[1:4])
        elif ps[0] == "map_Kd" and cur_mtl:
            has_map[cur_mtl] = True
            tex = ps[-1]
            src_tex = os.path.join(src_base, tex)
            if os.path.exists(src_tex):
                dst_tex = os.path.join(dst_dir, os.path.basename(tex))
                shutil.copy(src_tex, dst_tex)

    cur_mtl = None
    for line in lines:
        ps = line.split()
        if ps and ps[0] == "newmtl":
            cur_mtl = ps[1]
            out.append(line)
            if not has_map.get(cur_mtl, False) and cur_mtl in kd:
                # synthesize a texture so every material is textured

                tex_name = f"kd_{cur_mtl}.png"
                c = np.clip(np.array(kd[cur_mtl]) * 255, 0, 255).astype(np.uint8)
                write_png(
                    os.path.join(dst_dir, tex_name),
                    np.tile(c, (2, 2, 1)),
                )
                out.append(f"map_Kd {tex_name}\n")
        elif ps and ps[0] == "map_Kd":
            out.append(f"map_Kd {os.path.basename(ps[-1])}\n")
        else:
            out.append(line)
    with open(dst_mtl, "w") as f:
        f.writelines(out)

"""Directory-pair image scoring (port of ``gpcr_tpu/cli/pic_metrics.py``,
the pic_psnr.py / pic_mssim.py / pic_lpips.py equivalents in one module).

Conventions, as in the JAX package:
- images are matched as the sorted ``rgb_*.png`` listings of each directory;
- PSNR on 0-255 values: 20 log10(255) - 10 log10(mse);
- MS-SSIM with data_range 255 on raw 0-255 images;
- LPIPS: the reference feeds 0-255 images into lpips-alex;
  ``strict_parity=True`` reproduces that, False feeds [-1, 1];
- difference maps are written as (diff + 256) / 2 uint8.

The PNGs are read on the host; the metrics run on ``device`` (the
functions default to the CPU, ``main`` to the card).
"""

from __future__ import annotations

import os
import typing as T

import numpy as np
import torch

from ..io.image import read_png, write_png
from ..metrics import ms_ssim as _ms_ssim
from ..metrics import psnr255
from ..metrics.lpips import DEFAULT_WEIGHTS, LPIPS, lpips_available


def get_pic_list(pic_pth: str) -> T.List[str]:
    lis = sorted(os.listdir(pic_pth))
    return [os.path.join(pic_pth, n) for n in lis if n[:4] == "rgb_"]


def _load_pairs(p1: str, p2: str, device="cuda"):
    """Yields (path of the first image, img1, img2) as (H, W, 3) float32
    tensors on ``device``, img1 resized to img2's size where they differ."""
    dev = torch.device(device)
    ls1, ls2 = get_pic_list(p1), get_pic_list(p2)
    for f1, f2 in zip(ls1, ls2):
        img1 = torch.from_numpy(read_png(f1).astype(np.float32)).to(dev)
        img2 = torch.from_numpy(read_png(f2).astype(np.float32)).to(dev)
        if img1.shape[0] != img2.shape[0]:
            print(f"Resizing img1 with shape {tuple(img1.shape)} to img2 "
                  f"with shape {tuple(img2.shape)}")
            from ..render.renderer import bilinear_resize

            img1 = bilinear_resize(
                img1.permute(2, 0, 1), img2.shape[0], img2.shape[1],
            ).permute(1, 2, 0)
        yield f1, img1, img2


def psnr_dirs(p1: str, p2: str, diff_dir: T.Optional[str] = None,
              device="cuda") -> float:
    total, n = 0.0, 0
    for f1, img1, img2 in _load_pairs(p1, p2, device):
        total += float(psnr255(img1, img2))
        n += 1
        if diff_dir:
            os.makedirs(diff_dir, exist_ok=True)
            diff = (img1 - img2).cpu().numpy()
            write_png(
                os.path.join(diff_dir, os.path.basename(f1)),
                ((diff + 256) / 2).astype(np.uint8),
            )
    psnr = total / max(n, 1)
    print(f"psnr between {p1} and {p2}: " + "{:06}".format(psnr))
    return psnr


def msssim_dirs(p1: str, p2: str, device="cuda") -> float:
    total, n = 0.0, 0
    for _, img1, img2 in _load_pairs(p1, p2, device):
        total += float(_ms_ssim(img1.permute(2, 0, 1), img2.permute(2, 0, 1),
                                data_range=255.0))
        n += 1
    val = total / max(n, 1)
    print(f"MS-SSIM between {p1} and {p2}: " + "{:06}".format(val))
    return val


def lpips_dirs(p1: str, p2: str, strict_parity: bool = True,
               weights_path: T.Optional[str] = None,
               device="cuda") -> T.Optional[float]:
    wp = weights_path or DEFAULT_WEIGHTS
    if not lpips_available(wp):
        print(
            f"[Warn] LPIPS SKIPPED (no weights at {wp}).\n"
            f"       Pretrained AlexNet-LPIPS weights cannot be bundled; "
            f"convert the official lpips checkpoint once with:\n"
            f"         python -m gpcr_tpu_torch.cli.convert_lpips "
            f"/path/to/lpips_alex.pth\n"
            f"       (any `lpips.LPIPS(net='alex')` state-dict .pth works)"
        )
        return None
    model = LPIPS.load(wp).to(device)
    total, n = 0.0, 0
    with torch.no_grad():
        for _, img1, img2 in _load_pairs(p1, p2, device):
            a = img1.permute(2, 0, 1)[None]
            b = img2.permute(2, 0, 1)[None]
            if not strict_parity:
                a = a / 127.5 - 1.0
                b = b / 127.5 - 1.0
            total += float(model(a, b)[0])
            n += 1
    val = total / max(n, 1)
    print(f"LPIPS between {p1} and {p2}: " + "{:06}".format(val))
    return val


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("metric", choices=["psnr", "msssim", "lpips"])
    ap.add_argument("dir1")
    ap.add_argument("dir2")
    ap.add_argument("--diff_dir", default=None)
    ap.add_argument("--lpips_weights", default=None,
                    help="path to a converted lpips_alex.npz (defaults to "
                         "weights/lpips_alex.npz; see cli/convert_lpips.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device the metrics run on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to score on the CPU")
    if args.metric == "psnr":
        return psnr_dirs(args.dir1, args.dir2, args.diff_dir, device=device)
    if args.metric == "msssim":
        return msssim_dirs(args.dir1, args.dir2, device=device)
    return lpips_dirs(args.dir1, args.dir2, weights_path=args.lpips_weights,
                      device=device)


if __name__ == "__main__":
    main()

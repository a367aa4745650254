"""One-command LPIPS weight conversion (port of
``gpcr_tpu/cli/convert_lpips.py``).

The reference scores LPIPS with the pretrained ``lpips.LPIPS(net='alex')``
module. Those weights cannot be kept in the repository; this CLI converts
the official checkpoint into the npz layout both packages read:

    python -m gpcr_tpu_torch.cli.convert_lpips /path/to/lpips_alex.pth

Accepted inputs: a saved ``lpips.LPIPS(net='alex')`` state dict (e.g.
``torch.save(lpips.LPIPS(net='alex').state_dict(), 'lpips_alex.pth')``),
bare or wrapped in {'state_dict': ...}. After conversion,
``metrics.lpips.lpips_available()`` is True and every benchmark run scores
all three quality metrics (PSNR / MS-SSIM / LPIPS).
"""

import argparse

from ..metrics.lpips import DEFAULT_WEIGHTS, LPIPS, convert_lpips_pth


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert an lpips-alex .pth checkpoint to the npz "
                    "weight file the metrics read."
    )
    ap.add_argument("pth", help="path to the lpips.LPIPS(net='alex') .pth")
    ap.add_argument(
        "--out", default=DEFAULT_WEIGHTS,
        help=f"output npz path (default: {DEFAULT_WEIGHTS})",
    )
    args = ap.parse_args(argv)
    out = convert_lpips_pth(args.pth, args.out)
    # load it back so a schema mismatch fails HERE, not at benchmark time
    LPIPS.load(out)
    print(f"converted -> {out} (lpips_available() is now True)")


if __name__ == "__main__":
    main()

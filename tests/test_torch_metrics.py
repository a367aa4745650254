"""Port parity: PSNR, SSIM, MS-SSIM, LPIPS and the directory scorers of
``gpcr_tpu_torch`` against ``gpcr_tpu`` on the same numpy images.

Tolerances: PSNR / SSIM / MS-SSIM at 1e-5 absolute (float32 window sums in
another order; PSNR in dB on 0-255 images); LPIPS with the JAX package's
``random_lpips`` weights carried over at 1e-4 relative (five float32
convolutions deep); the directory scorers read the same PNG bytes and are
held to the same limits.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from gpcr_tpu import metrics as JM
from gpcr_tpu.cli import pic_metrics as JPM
from gpcr_tpu.metrics import lpips as JL
from gpcr_tpu_torch import metrics as TM
from gpcr_tpu_torch.cli import convert_lpips as TCL
from gpcr_tpu_torch.cli import pic_metrics as TPM
from gpcr_tpu_torch.io import write_png
from gpcr_tpu_torch.metrics import lpips as TL
from gpcr_tpu_torch.render import renderer as TRD
from gpcr_tpu_torch.render.checkpoint import lpips_from_jax_params

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)


def _pair(h, w, seed=0, channels=3):
    """Two correlated 0-255 images, (C, H, W) float32."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx / 7.0 + seed) * np.cos(yy / 11.0)
    a = np.clip(base[None] + rng.randn(channels, h, w) * 20, 0, 255)
    b = np.clip(a + rng.randn(channels, h, w) * 12, 0, 255)
    return a.astype(np.float32), b.astype(np.float32)


def test_psnr_matches_jax():
    a, b = _pair(40, 56)
    got = float(TM.psnr255(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - float(JM.psnr255(a, b))) <= 1e-5
    assert 20 < got < 35
    a01, b01 = a.transpose(1, 2, 0) / 255, b.transpose(1, 2, 0) / 255
    got01 = float(TM.psnr(torch.from_numpy(a01), torch.from_numpy(b01)))
    assert abs(got01 - float(JM.psnr(a01, b01))) <= 1e-5
    assert abs(got01 - got) <= 1e-3  # the two conventions agree
    u8 = float(TM.psnr255(torch.from_numpy(a.astype(np.uint8)),
                          torch.from_numpy(b.astype(np.uint8))))
    assert abs(u8 - float(JM.psnr255(a.astype(np.uint8),
                                     b.astype(np.uint8)))) <= 1e-5


@pytest.mark.parametrize("sample_covariance", [False, True])
def test_ssim_matches_jax(sample_covariance):
    a, b = _pair(48, 40, seed=1)
    kw = dict(data_range=255.0, sample_covariance=sample_covariance)
    got = float(TM.ssim(torch.from_numpy(a), torch.from_numpy(b), **kw))
    assert abs(got - float(JM.ssim(a, b, **kw))) <= 1e-5
    assert 0.3 < got < 1.0
    # numpy inputs are taken too, and the default range is [0, 1]
    got01 = float(TM.ssim(a / 255, b / 255,
                          sample_covariance=sample_covariance))
    assert abs(got01 - got) <= 1e-4


@pytest.mark.parametrize(
    "h,w,levels", [(192, 180, 5), (64, 72, 3), (181, 203, 5)],
    ids=["five-scales", "truncated", "odd-sides"])
def test_ms_ssim_matches_jax(h, w, levels):
    a, b = _pair(h, w, seed=2)
    feasible = 1
    while feasible < 5 and (min(h, w) >> feasible) >= 11:
        feasible += 1
    assert feasible == levels
    got = float(TM.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - float(JM.ms_ssim(a, b))) <= 1e-5
    assert 0.5 < got < 1.0
    same = float(TM.ms_ssim(torch.from_numpy(a), torch.from_numpy(a)))
    assert abs(same - 1.0) <= 1e-6


def test_lpips_matches_jax_with_carried_weights():
    jmodel = JL.random_lpips()
    tmodel = lpips_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jmodel.params))
    a, b = _pair(64, 80, seed=3)
    x, y = a[None] / 127.5 - 1.0, b[None] / 127.5 - 1.0
    ref = np.asarray(jmodel(x, y))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (1,) and ref[0] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # strict parity feeds 0-255 images, as the reference's scorer does
    with torch.no_grad():
        got255 = tmodel(torch.from_numpy(a[None]), torch.from_numpy(b[None]))
    np.testing.assert_allclose(got255.numpy(),
                               np.asarray(jmodel(a[None], b[None])), rtol=1e-4)
    # the port's own random weights: seeded, and not a function of img order
    r1, r2 = TL.random_lpips(), TL.random_lpips()
    with torch.no_grad():
        d12 = r1(torch.from_numpy(x), torch.from_numpy(y))
        d21 = r2(torch.from_numpy(y), torch.from_numpy(x))
        d11 = r1(torch.from_numpy(x), torch.from_numpy(x))
    assert float(d12) > 0 and float(d11) == 0
    np.testing.assert_allclose(d12.numpy(), d21.numpy(), rtol=1e-6)


def _alex_state_dict(model):
    """The model's weights under the ``lpips`` package's key names."""
    sd = {}
    for i, li in enumerate([0, 3, 6, 8, 10]):
        sd[f"net.slice{i + 1}.{li}.weight"] = getattr(model, f"conv{i}_kernel")
        sd[f"net.slice{i + 1}.{li}.bias"] = getattr(model, f"conv{i}_bias")
        sd[f"lins.{i}.model.1.weight"] = getattr(model, f"lin{i}")
    return sd


def _write_dirs(tmp_path, sizes):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    for i, (s1, s2) in enumerate(sizes):
        a, _ = _pair(*s1, seed=10 + i)
        _, b = _pair(*s2, seed=10 + i)
        write_png(str(d1 / f"rgb_{i}.png"), a.transpose(1, 2, 0).astype(np.uint8))
        write_png(str(d2 / f"rgb_{i}.png"), b.transpose(1, 2, 0).astype(np.uint8))
    write_png(str(d1 / "normal_w_0.png"), np.zeros((4, 4, 3), np.uint8))
    return str(d1), str(d2)


def test_dir_scorers_match_jax(tmp_path, capsys):
    """The three ``*_dirs`` functions and the converter on PNGs both
    packages read; the second pair needs the resize."""
    d1, d2 = _write_dirs(tmp_path, [((48, 48), (48, 48)), ((96, 96), (48, 48))])
    assert [p[-9:] for p in TPM.get_pic_list(d1)] == ["rgb_0.png", "rgb_1.png"]
    assert TPM.get_pic_list(d1) == JPM.get_pic_list(d1)

    ref = JPM.psnr_dirs(d1, d2, diff_dir=str(tmp_path / "jdiff"))
    j_out = capsys.readouterr().out
    got = TPM.psnr_dirs(d1, d2, diff_dir=str(tmp_path / "tdiff"),
                        device="cpu")
    t_out = capsys.readouterr().out
    assert abs(got - ref) <= 1e-5
    # the printed lines, the resize notice included; the last digits of the
    # mean may differ within the tolerance
    assert t_out.splitlines()[0] == j_out.splitlines()[0]
    assert t_out.startswith("Resizing img1 with shape (96, 96, 3) to img2")
    t_last, j_last = t_out.splitlines()[-1], j_out.splitlines()[-1]
    assert t_last.rsplit(": ", 1)[0] == j_last.rsplit(": ", 1)[0]
    assert t_last == f"psnr between {d1} and {d2}: " + "{:06}".format(got)
    for name in ("rgb_0.png", "rgb_1.png"):
        a = TPM.read_png(str(tmp_path / "tdiff" / name)).astype(int)
        b = TPM.read_png(str(tmp_path / "jdiff" / name)).astype(int)
        assert np.abs(a - b).max() <= 1  # the resized pair rounds apart

    assert abs(TPM.msssim_dirs(d1, d2, device="cpu")
               - JPM.msssim_dirs(d1, d2)) <= 1e-5
    capsys.readouterr()

    # no weights in the tree: the explicit skip and its message
    missing = str(tmp_path / "none.npz")
    assert TPM.lpips_dirs(d1, d2, weights_path=missing, device="cpu") is None
    out = capsys.readouterr().out
    assert "LPIPS SKIPPED" in out and "gpcr_tpu_torch.cli.convert_lpips" in out
    assert not TL.lpips_available(missing)

    # a .pth under the lpips package's names -> the npz both packages load
    model = TL.random_lpips()
    pth, npz = str(tmp_path / "alex.pth"), str(tmp_path / "w" / "alex.npz")
    torch.save({"state_dict": _alex_state_dict(model)}, pth)
    TCL.main([pth, "--out", npz])
    assert TL.lpips_available(npz)
    for strict in (True, False):
        ref = JPM.lpips_dirs(d1, d2, strict_parity=strict, weights_path=npz)
        got = TPM.lpips_dirs(d1, d2, strict_parity=strict, weights_path=npz,
                             device="cpu")
        assert ref > 0 and abs(got - ref) <= 1e-4 * ref
    with pytest.raises(ValueError, match="convert_lpips_pth"):
        TL.LPIPS.load(pth)

    assert TPM.main(["psnr", d1, d2, "--device", "cpu"]) == TPM.psnr_dirs(
        d1, d2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TPM.main(["msssim", d1, d2])


@pytest.mark.parametrize("fn", [TPM._load_pairs, TPM.psnr_dirs,
                                TPM.msssim_dirs, TPM.lpips_dirs,
                                TRD.PCMLRender])
def test_entry_points_default_to_the_card(fn):
    """The port's entry points run on the card unless the caller asks for
    the CPU: their ``device`` parameter defaults to ``cuda`` (read from
    the signature, so this runs without a card)."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"

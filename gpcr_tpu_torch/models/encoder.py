"""PCEncoder — the splat-parameter prediction head (port of
``gpcr_tpu/models/encoder.py``, reference ``models/model_v2.py:238-375``).

Runs a backbone over a quantized coloured voxel grid — the SparseUNet
(``model_type`` "unet"), Point Transformer V3 with its Linear head
(``model_type`` "ptv3", ``models/ptv3.py``), Point Transformer V2 with
its seg head (``model_type`` "ptv2", ``models/ptv2.py``) or Swin3D with
its classifier (``model_type`` "swin3d", ``models/swin3d.py``) — and splits
its output into
per-voxel Gaussian parameters with the reference activations:
rotation = feat + [1,0,0,0]; scale = clamp(feat + 1, min=0); opacity =
clamp(feat, 0, 1); offset = feat; SH DC = RGB2SH(input rgb) [+ learned
offset]; normal = feat, optionally L2-normalized; SH AC learned or zeros.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
from torch import nn

from ..ops import sparse
from ..utils import trace
from ..utils.sh import RGB2SH
from .ptv2 import PointTransformerV2, PTv2Config
from .ptv3 import PointTransformerV3, PTv3Config
from .swin3d import Swin3DConfig, Swin3DUNet
from .unet import SparseUNet

# the transformer backbones: model_type -> (PCMLInfo field, config class,
# model class)
_WIDTHS = {"ptv3": ("ptv3", PTv3Config, PointTransformerV3),
           "ptv2": ("ptv2", PTv2Config, PointTransformerV2),
           "swin3d": ("swin3d", Swin3DConfig, Swin3DUNet)}


@dataclasses.dataclass(frozen=True)
class PCMLInfo:
    """Typed view of the checkpoint's ``pcml_info`` dict."""

    clr_encoder_channels: str = "9 32 64 128 256 128"
    sh_deg: int = 1
    sh_feat_deg: int = 0
    use_rotation: bool = True
    use_scale: bool = True
    use_offset: bool = True
    use_dc_offset: bool = False
    use_opacity: bool = False
    est_normal: bool = True
    normalize_normal: bool = True
    enable_opacity: bool = True
    scale_factor: int = 256
    model_type: str = "unet"
    normalize_camera_normal: bool = True
    # model_type "ptv3" / "ptv2" / "swin3d": the backbone's widths; the
    # input width is clr_encoder_channels' first entry
    ptv3: T.Optional[PTv3Config] = None
    ptv2: T.Optional[PTv2Config] = None
    swin3d: T.Optional[Swin3DConfig] = None

    def __post_init__(self):
        field, config, _ = _WIDTHS.get(self.model_type, (None, None, None))
        if field is not None and getattr(self, field) is None:
            object.__setattr__(self, field, config(in_channels=self.in_dim))

    @staticmethod
    def from_dict(d: dict) -> "PCMLInfo":
        """The fields ``d`` gives; for a transformer ``model_type`` ("ptv3",
        "ptv2", "swin3d") also the backbone config's keys at the top level
        of ``d`` (lists as tuples)."""
        names = {f.name for f in dataclasses.fields(PCMLInfo)} - {
            field for field, _, _ in _WIDTHS.values()}
        info = PCMLInfo(**{k: v for k, v in d.items() if k in names})
        if info.model_type not in _WIDTHS:
            return info
        field, config, _ = _WIDTHS[info.model_type]
        keys = {f.name for f in dataclasses.fields(config)}
        widths = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in keys}
        widths["in_channels"] = info.in_dim
        return dataclasses.replace(info, **{field: config(**widths)})

    @property
    def channels(self) -> T.List[int]:
        return [int(x) for x in self.clr_encoder_channels.split(" ")]

    @property
    def in_dim(self) -> int:
        return self.channels[0]

    @property
    def feat_dim(self) -> int:
        d = 0
        if self.use_rotation:
            d += 4
        if self.use_scale:
            d += 3
        if self.use_offset:
            d += 3
        if self.use_dc_offset:
            d += 3
        if self.use_opacity:
            d += 1
        if self.est_normal:
            d += 3
        if self.sh_feat_deg > 0:
            d += (2 ** (self.sh_feat_deg + 1)) * 3
        return d


class SplatParams(T.NamedTuple):
    """Per-voxel Gaussian splat parameters (grid units)."""

    primitives: torch.Tensor  # (N, 3) voxel coords + offset
    sh: torch.Tensor  # (N, K, 3)
    rotation: torch.Tensor  # (N, 4)
    scale: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N, 1)
    center_points: torch.Tensor  # (N, 3) voxel coords (pre-offset)
    offsets: T.Optional[torch.Tensor]  # (N, 3)
    normal: T.Optional[torch.Tensor]  # (N, 3)
    valid: torch.Tensor  # (N,) all true: levels hold exactly their voxels


class PCEncoder(nn.Module):
    """Its sub-module is named ``color_encoder`` so parameter names match
    the JAX param dict and the reference state dict
    (``color_encoder.conv0.kernel``, ...). Built on the CPU from
    ``generator``; move it with ``.to(device)``."""

    def __init__(self, info: T.Union[dict, PCMLInfo],
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        self.info = (info if isinstance(info, PCMLInfo)
                     else PCMLInfo.from_dict(info))
        if self.info.model_type == "unet":
            self.color_encoder = SparseUNet(
                self.info.channels, self.info.feat_dim, generator=generator)
        elif self.info.model_type in _WIDTHS:
            field, _, model = _WIDTHS[self.info.model_type]
            self.color_encoder = model(getattr(self.info, field),
                                       self.info.feat_dim,
                                       generator=generator)
        else:
            raise NotImplementedError(
                f"Model type {self.info.model_type} not implemented!")

    def build_plan(self, grid: sparse.SparseGrid) -> dict:
        return self.color_encoder.build_plan(grid)

    def forward(self, grid: sparse.SparseGrid, plan: dict) -> SplatParams:
        """``grid.feats``' LAST 3 channels are the input rgb."""
        info = self.info
        with trace.span(f"gpcr.encode.{info.model_type}"):
            feat = self.color_encoder(grid, plan)  # (N, F)
        with trace.span("gpcr.encode.head"):
            rgb_in = grid.feats[:, -3:]
            n = feat.shape[0]
            dev = feat.device
            ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
            used = 0

            if info.use_rotation:
                rot = feat[:, 0:4] + ident
                used += 4
            else:
                rot = ident.expand(n, 4).clone()
            if info.use_scale:
                scale = torch.clamp(feat[:, used:used + 3] + 1.0, min=0.0)
                used += 3
            else:
                scale = torch.ones((n, 3), device=dev)
            if info.use_opacity:
                opacity = torch.clamp(feat[:, used:used + 1], 0.0, 1.0)
                used += 1
            else:
                opacity = torch.ones((n, 1), device=dev)
            if info.use_offset:
                offsets = feat[:, used:used + 3]
                used += 3
            else:
                offsets = None
            if info.use_dc_offset:
                sh_dc = (feat[:, used:used + 3] + RGB2SH(rgb_in))[:, None, :]
                used += 3
            else:
                sh_dc = RGB2SH(rgb_in)[:, None, :]
            if info.est_normal:
                normal = feat[:, used:used + 3]
                used += 3
                if info.normalize_normal:
                    norm2 = torch.sum(normal ** 2, dim=-1, keepdim=True)
                    safe = torch.sqrt(torch.where(norm2 > 0, norm2,
                                                  torch.ones_like(norm2)))
                    normal = torch.where(norm2 > 0, normal / safe,
                                         torch.zeros_like(normal))
            else:
                normal = None

            if info.sh_deg > 0 and info.sh_feat_deg > 0:
                sh = torch.cat([sh_dc, feat[:, used:].reshape(n, -1, 3)],
                               dim=1)
            elif info.sh_deg > 0:
                pseudo = (2 ** (info.sh_deg + 1)) * 3
                sh = torch.cat(
                    [sh_dc, torch.zeros((n, pseudo, 3), device=dev)], dim=1)
            else:
                sh = sh_dc

            center = grid.coords().to(torch.float32) * grid.stride
            primitives = center + offsets if info.use_offset else center
            return SplatParams(
                primitives=primitives, sh=sh, rotation=rot, scale=scale,
                opacity=opacity, center_points=center, offsets=offsets,
                normal=normal,
                valid=torch.ones((n,), dtype=torch.bool, device=dev),
            )


def assemble_input_features(info: PCMLInfo, xyz_grid: torch.Tensor,
                            rgb: torch.Tensor, offset: float = 512.0):
    """Input features by in_dim: 3 -> [rgb]; 6 -> [quantize-offset, rgb];
    9 -> [(xyz - offset)/scale_factor, quantize-offset, rgb]."""
    qoff = xyz_grid - torch.round(xyz_grid)
    if info.in_dim == 3:
        return rgb
    if info.in_dim == 6:
        return torch.cat([qoff, rgb], dim=-1)
    if info.in_dim == 9:
        world = (xyz_grid - offset) / info.scale_factor
        return torch.cat([world, qoff, rgb], dim=-1)
    raise NotImplementedError(f"in_dim={info.in_dim}")

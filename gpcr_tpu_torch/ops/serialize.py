"""Serialization of a voxel hierarchy for Point Transformer V3 (Wu et al.,
CVPR 2024; Pointcept's ``models/utils/serialization``): space-filling-curve
codes, the orders they give, the patches of the serialized attention and
the pooling clusters. Everything here is geometry only: ``ptv3.build_plan``
runs it once per cloud and the renderer keeps the result with its plan.

- ``morton``: bit i of x at 3i + 2, of y at 3i + 1, of z at 3i (OCNN's
  ``xyz2key``);
- ``hilbert``: the Hilbert code of PrincetonLIPS' ``numpy-hilbert-curve``
  (Pointcept's ``hilbert.encode``) on integer coordinates: per bit from
  the top and per axis d, where the axis' bit is set the lower bits of
  axis 0 are inverted, else the lower bits of axes 0 and d are exchanged
  where they differ; the bits are interleaved as Morton's and Gray-decoded;
- ``-trans`` orders encode ``g[:, [1, 0, 2]]``;
- a pooled level's codes are its children's codes ``>> 3`` (Pointcept does
  not encode a pooled level anew), so the clusters of ``code_z >> 3`` are
  the parents ``g >> 1``;
- patches: K = min(patch_size, N) consecutive points of an order; the last
  patch is the last K points, and only the N mod K points no earlier patch
  holds keep its outputs (Pointcept's ``get_padding_and_inverse``).
"""

from __future__ import annotations

import dataclasses

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def depth_of(g: torch.Tensor) -> int:
    """Bits per axis of the codes: bit_length of the largest coordinate
    (one host read)."""
    return int(g.max()).bit_length()


def _spread(v: torch.Tensor, depth: int) -> torch.Tensor:
    """Bit i of ``v`` moved to bit 3i."""
    out = torch.zeros_like(v)
    for i in range(depth):
        out |= ((v >> i) & 1) << (3 * i)
    return out


def morton(g: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 -> (N,) Morton code."""
    g = g.long()
    return ((_spread(g[:, 0], depth) << 2) | (_spread(g[:, 1], depth) << 1)
            | _spread(g[:, 2], depth))


def hilbert(g: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 -> (N,) Hilbert code of ``depth`` bits per axis."""
    a = [g[:, i].long().clone() for i in range(3)]
    for p in range(depth - 1, -1, -1):
        low = (1 << p) - 1
        for d in range(3):
            on = ((a[d] >> p) & 1).bool()
            a[0] = torch.where(on, a[0] ^ low, a[0])
            flip = torch.where(on, torch.zeros_like(a[0]),
                               (a[0] ^ a[d]) & low)
            a[d] = a[d] ^ flip
            a[0] = a[0] ^ flip
    code = morton(torch.stack(a, dim=1), depth)
    shift = 1
    while shift < 3 * depth:  # Gray decode: prefix XOR from the top bit
        code = code ^ (code >> shift)
        shift <<= 1
    return code


def encode(g: torch.Tensor, order: str, depth: int) -> torch.Tensor:
    """The code of ``order`` (one of ``ORDERS``) of every voxel."""
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
        order = order[:-len("-trans")]
    if order == "z":
        return morton(g, depth)
    if order == "hilbert":
        return hilbert(g, depth)
    raise ValueError(f"unknown order {order!r}")


def pooled_codes(codes: torch.Tensor, parent: torch.Tensor,
                 n_parents: int) -> torch.Tensor:
    """(orders, N) codes of a level, each voxel's parent (N,) -> (orders,
    n_parents) codes of the parents: the children's codes >> 3, which
    every child of a parent shares."""
    out = codes.new_zeros((codes.shape[0], n_parents))
    out[:, parent] = codes >> 3
    return out


@dataclasses.dataclass
class Patches:
    """One order's serialized attention layout at one level: ``order``
    (N,) the voxel row at each serialized position, ``pad_rows`` (patches
    x K,) the voxel row of each patch slot and ``unpad_slots`` (N,) the
    slot whose output each voxel keeps."""

    order: torch.Tensor  # (N,) int32, what csrc/patch_attn.cu reads
    pad_rows: torch.Tensor  # (patches * k,) int64
    unpad_slots: torch.Tensor  # (N,) int64
    n: int
    k: int
    patches: int

    @property
    def pad_rows_shared(self) -> int:
        """Rows the last patch computes again: slots - N."""
        return self.patches * self.k - self.n


def patches_of(code: torch.Tensor, patch_max: int) -> Patches:
    """The patch layout of one order's codes (N,) at one level: K =
    min(patch_max, N) (Pointcept's rule with ``enable_flash=False``),
    patch p starting at min(p K, N - K)."""
    n = code.shape[0]
    dev = code.device
    order = torch.argsort(code)
    k = max(1, min(patch_max, n))
    patches = -(-n // k)
    starts = torch.clamp(torch.arange(patches, device=dev) * k, max=n - k)
    pad_pos = (starts[:, None] + torch.arange(k, device=dev)).reshape(-1)
    pos = torch.arange(n, device=dev)
    p = torch.clamp(pos // k, max=patches - 1)
    slot_of_pos = p * k + (pos - starts[p])
    inverse = torch.empty_like(order)
    inverse[order] = pos
    return Patches(order=order.to(torch.int32), pad_rows=order[pad_pos],
                   unpad_slots=slot_of_pos[inverse], n=n, k=k,
                   patches=patches)

"""The ('dp', 'sp') rank mesh for training and multi-GPU rendering (port
of ``gpcr_tpu/parallel/sharding.py``).

- data parallel (dp): the point-cloud batch split over 'dp', the model
  replicated, gradients summed over all ranks;
- view parallel (sp): the views of each cloud split over 'sp'.

JAX places global arrays on a device mesh and lets the compiler insert
the collectives. Here every rank is one process holding its own slice:
``shard_batch`` cuts a rank's slice out of the global batch, and the
``Mesh`` runs the collectives over each axis's process group.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.distributed as dist

from .distributed import get_rank, get_world_size

AXES = ("dp", "sp")


@dataclasses.dataclass
class Mesh:
    """A dp x sp layout of the ranks: rank r sits at (r // sp, r % sp), as
    ``np.array(devices).reshape(dp, sp)`` places JAX's devices.

    ``shape[axis]`` is the axis's size, ``coords[axis]`` this rank's index
    on it, ``groups[axis]`` the process group of the ranks that share this
    rank's other coordinate, ``world`` the group of all ranks (all None
    without a process group: a 1 x 1 mesh, whose collectives return their
    input)."""

    shape: T.Dict[str, int]
    coords: T.Dict[str, int]
    groups: T.Dict[str, T.Any]
    world: T.Any = None

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The equal-shaped blocks of all ranks on ``axis``, concatenated
        along dim 0 in axis order."""
        group = self.groups[axis]
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axes: T.Sequence[str] = AXES) -> torch.Tensor:
        """``t`` reduced (``sum`` or ``max``) in place over the ranks of
        ``axes`` (all ranks by default); returns it."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        groups = ([self.world] if tuple(axes) == AXES
                  else [self.groups[a] for a in axes])
        for group in groups:
            if group is not None:
                dist.all_reduce(t, op=red, group=group)
        return t


def make_mesh(n_devices: T.Optional[int] = None, dp: T.Optional[int] = None,
              sp: T.Optional[int] = None) -> Mesh:
    """The ('dp', 'sp') mesh over every rank. Defaults: all ranks on dp.
    Without a process group it is 1 x 1. Every rank must call it (it
    creates the axes' process groups)."""
    world = get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: a mesh of {n} ranks in a world of "
                         f"{world}: start one process per card (torchrun "
                         f"--nproc_per_node {n})")
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"make_mesh: dp ({dp}) x sp ({sp}) must equal the "
                         f"world ({n})")
    r = get_rank()
    coords = {"dp": r // sp, "sp": r % sp}
    groups, world_group = {"dp": None, "sp": None}, None
    if dist.is_initialized():
        world_group = dist.group.WORLD
        # every rank creates every group, in the same order
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)])
            if i == coords["dp"]:
                groups["sp"] = g
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)])
            if j == coords["sp"]:
                groups["dp"] = g
    return Mesh(shape={"dp": dp, "sp": sp}, coords=coords, groups=groups,
                world=world_group)


def batch_sharding(mesh: Mesh) -> T.Dict[str, T.Tuple[str, ...]]:
    """The mesh axes that split each leading dim of a batch entry: clouds
    (B, N, ...) split B over dp; views (B, V, ...) split B over dp and V
    over sp; replicated entries are not split."""
    del mesh  # the same split on every mesh, as in JAX
    return {"cloud": ("dp",), "view": ("dp", "sp"), "replicated": ()}


def _replicated_tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict().values())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _replicated_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _replicated_tensors(v)]
    raise TypeError(f"replicate: cannot broadcast a {type(obj).__name__}")


def replicate(module_or_tensors, mesh: Mesh):
    """Give every rank rank 0's values: each tensor of a module's state
    dict (parameters and buffers), or of a tensor / nested dict / list, is
    broadcast from rank 0 in place. Returns its argument."""
    if mesh.world is not None:
        for t in _replicated_tensors(module_or_tensors):
            dist.broadcast(t, src=0, group=mesh.world)
    return module_or_tensors


# canonical batch-key shardings; extend via shard_batch(spec=...): unknown
# keys RAISE rather than silently mis-shard
_CLOUD_KEYS = frozenset({"coords", "rgb", "valid", "normal", "feature"})
_VIEW_KEYS = frozenset(
    {"view_t", "full_t", "campos", "gt_rgb", "gt_normal", "gt_hit"})


def _split(x: torch.Tensor, dim: int, n: int, i: int, key: str):
    if x.shape[dim] % n:
        raise ValueError(f"shard_batch: {key!r} has {x.shape[dim]} rows on "
                         f"dim {dim}, not a multiple of {n}")
    per = x.shape[dim] // n
    return x.narrow(dim, i * per, per)


def shard_batch(batch: dict, mesh: Mesh,
                spec: T.Optional[T.Dict[str, str]] = None) -> dict:
    """This rank's slice of a global batch dict.

    Keys with leading (B, N) point dims are clouds ('cloud': B over dp);
    keys with (B, V, ...) view dims are views ('view': B over dp, V over
    sp); 0-d entries are replicated. New keys must be declared in ``spec``
    (key -> 'cloud' | 'view' | 'replicated'); an unknown key raises
    instead of being silently split."""
    axes = batch_sharding(mesh)
    kinds = {k: "cloud" for k in _CLOUD_KEYS}
    kinds.update({k: "view" for k in _VIEW_KEYS})
    if spec:
        kinds.update(spec)
    out = {}
    for k, v in batch.items():
        kind = kinds.get(k)
        if kind is None and getattr(v, "ndim", 1) == 0:
            kind = "replicated"
        if kind is None:
            raise ValueError(
                f"shard_batch: unknown batch key {k!r}; declare it via "
                f"spec={{{k!r}: 'cloud' | 'view' | 'replicated'}}")
        for dim, axis in enumerate(axes[kind]):
            v = _split(v, dim, mesh.shape[axis], mesh.coords[axis], k)
        out[k] = v
    return out

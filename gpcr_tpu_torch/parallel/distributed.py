"""Process-group start-up for multi-GPU runs (port of
``gpcr_tpu/parallel/distributed.py``).

One process per card, started by ``torchrun`` (or any launcher that sets
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``), calls ``initialize()`` once before it touches the card:

    torchrun --nproc_per_node 4 -m gpcr_tpu_torch.cli.train --sp 2

``parallel.sharding.make_mesh`` then lays the ranks out as a ('dp', 'sp')
mesh. A single process without a launcher stays without a process group,
as JAX's ``initialize`` is a no-op without a coordinator.
"""

from __future__ import annotations

import os
import typing as T

import torch
import torch.distributed as dist


def initialize(
    init_method: T.Optional[str] = None,
    world_size: T.Optional[int] = None,
    rank: T.Optional[int] = None,
    backend: T.Optional[str] = None,
) -> bool:
    """Start the default process group; returns True when this call
    started it.

    The arguments default to torchrun's ``WORLD_SIZE`` / ``RANK``; the
    rendezvous is ``init_method`` (e.g. ``tcp://localhost:<port>`` or
    ``file://<path>``), else ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``). Without an init method, a ``MASTER_ADDR`` or a world
    above 1 it does nothing and returns False, as it does when a group is
    already running. A world of 1 with a rendezvous is a real one-rank
    group (``torchrun --nproc_per_node 1``). ``backend`` defaults to
    ``nccl`` when a card is present (after ``torch.cuda.set_device
    (LOCAL_RANK)``) and ``gloo`` otherwise; CPU runs pass ``gloo``.
    """
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if dist.is_initialized():
        return False
    if init_method is None and not env.get("MASTER_ADDR") and (
            world_size or 1) <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=1 if world_size is None else world_size,
        rank=0 if rank is None else rank)
    return True


def get_world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 (or no group): the process that writes files and logs."""
    return get_rank() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The [start, end) slice of a global batch this rank owns under plain
    dp sharding."""
    p, i = get_world_size(), get_rank()
    per = -(-global_batch // p)
    return slice(i * per, min((i + 1) * per, global_batch))

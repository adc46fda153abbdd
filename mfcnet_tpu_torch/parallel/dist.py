"""Data parallelism over ``torch.distributed`` (counterpart of
``mfcnet_tpu/parallel/mesh.py``).

The JAX package runs one process over a mesh of devices, shards each batch
over its ``data`` axis and lets XLA insert the collectives: the gradient
all-reduce and, because a batch reduction over a sharded axis is global,
batch-norm statistics and losses over the whole batch. The port runs one
process per device (``torchrun --nproc_per_node N``): the gradient
all-reduce is ``DistributedDataParallel``'s, and what XLA made global by
itself is summed over the group here by hand (:func:`all_sum`): the batch
norms' statistics and their gradient sums (``models/common.py``) and the
losses' partial sums (``train/loss.py``).

Rank r holds rows ``r*b .. (r+1)*b-1`` of each global batch of ``b *
world`` samples (:func:`rank_rows`), as the JAX package stitches the
processes' local batches in process order.

At world 1 -- no group, or a group of one process -- every helper here is
a no-op, and the code paths that call them are the single-process ones.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def group_world() -> int:
    """Processes in the default group; 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def group_rank() -> int:
    """This process's rank in the default group; 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def init_distributed(auto: bool = False, device="cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0):
    """Join the process group that ``torchrun`` (or the caller) describes in
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; returns
    (rank, world). A no-op returning (0, 1) unless ``auto`` (the training
    CLIs' ``--multihost true``) or ``WORLD_SIZE`` > 1 asks for a group; with
    ``auto`` and no ``WORLD_SIZE`` it forms a group of one process. Called
    again, it returns the group that exists.

    ``backend``: ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU by
    default. NCCL refuses two ranks on one card; ``gloo`` reduces CUDA
    tensors through the host, which is how two ranks share one card (the
    tests, ``chip_smoke.py``). A collective that waits longer than
    ``timeout_s`` raises, so that a lost rank fails the others."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not (auto or world > 1):
        return 0, 1
    rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def local_device(name: str) -> torch.device:
    """The device of this process: ``cuda`` without an index is
    ``cuda:LOCAL_RANK`` (one process per card); any other name is kept
    (``cpu``, or ``cuda:0`` for ranks that share a card)."""
    if name == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(name)


def rank_rows(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n_global``."""
    if n_global % world:
        raise ValueError(f"a global batch of {n_global} does not split "
                         f"over {world} ranks")
    b = n_global // world
    return slice(rank * b, (rank + 1) * b)


class _AllSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients over
    the group too. Every rank's loss is then the global one, and each
    rank's gradient is ``world`` times the global loss's gradient through
    its own rows, which ``DistributedDataParallel``'s mean over ranks turns
    into the global loss's gradient."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out)
        return out


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group, differentiably (see :class:`_AllSum`);
    ``x`` itself at world 1."""
    if group_world() == 1:
        return x
    return _AllSum.apply(x)

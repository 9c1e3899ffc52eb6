"""The collectives of the sharded forward, over `torch.distributed`.

A JAX `shard_map` body names mesh axes in its collectives; here each rank
is a process, a mesh axis is an `Axis` (this rank's process group along
it), and the collectives the forward needs map as

    lax.psum                      -> all_reduce (a sum, in place)
    lax.all_gather(tiled=True)    -> all_gather (concatenated along a dim)
    lax.ppermute                  -> send / recv between neighbours
    (psum of a one-hot stage)     -> broadcast from one index of the axis

The backend follows from where the ranks run (`multihost.choose_backend`):
NCCL when every rank has a card of its own, gloo when ranks share one card
or run on the CPU. gloo has CUDA forms of all_reduce and broadcast only
(torch.distributed's backend table), so for CUDA tensors over gloo the
gathers and the point-to-point copies go through the host, explicitly,
each in its own function below; every other case passes the tensor as it
is. Nothing is chosen by catching a failure.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its name, its size, this rank's
    index along it, the global ranks along it (in axis order) and their
    process group (None for a size-1 axis, whose collectives are the
    identity). `host_copy`: the group is gloo and the tensors live on a
    card, so gathers and point-to-point copies go through the host."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object | None = None
    host_copy: bool = False


def all_reduce(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum of x over the axis, in place (every rank gets the same
    bits: the backends reduce each element once and copy the result)."""
    if axis is not None and axis.size > 1:
        dist.all_reduce(x, group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: Axis | None, dim: int = -1) -> torch.Tensor:
    """The axis's shards of x concatenated along `dim`, in axis order (a
    tiled all-gather)."""
    if axis is None or axis.size == 1:
        return x
    src = x.contiguous().cpu() if axis.host_copy else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x: torch.Tensor, axis: Axis | None, src_index: int) -> torch.Tensor:
    """x of the rank at `src_index` along the axis, on every rank (in
    place)."""
    if axis is not None and axis.size > 1:
        dist.broadcast(x, src=axis.ranks[src_index], group=axis.group)
    return x


def send(x: torch.Tensor, axis: Axis, dst_index: int) -> None:
    """Send x to the rank at `dst_index` along the axis (blocking)."""
    src = x.contiguous().cpu() if axis.host_copy else x.contiguous()
    dist.send(src, dst=axis.ranks[dst_index], group=axis.group)


def recv(like: torch.Tensor, axis: Axis, src_index: int) -> torch.Tensor:
    """A tensor of like's shape, type and device received from the rank at
    `src_index` along the axis (blocking)."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if axis.host_copy else like.device)
    dist.recv(buf, src=axis.ranks[src_index], group=axis.group)
    return buf.to(like.device)


def same_on_every_rank(values: np.ndarray, group, what: str) -> None:
    """Every rank's `values` must equal rank 0's: an all-gather over the
    (gloo, host-side) `group`, so that every rank sees every copy and all
    raise RuntimeError together when one differs."""
    copies: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(copies, values.tobytes(), group=group)
    bad = [r for r, c in enumerate(copies) if c != copies[0]]
    if bad:
        raise RuntimeError(f"{what} differ between ranks: ranks {bad} disagree with rank 0")

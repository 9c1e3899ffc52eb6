"""Process-group setup of the parallel runtime (twin of
`llamavk_tpu/parallel/multihost.py`, over `torch.distributed`).

Every rank is one process running the same program, as every host of a JAX
pod runs the same program. `initialize` brings the group up (idempotent),
with a timeout so that a rank that never arrives fails the others instead
of leaving them waiting; `shutdown` tears it down. The placement rules are
the JAX ones: a mesh puts its tp axis over the ranks of one host, so the
per-token collectives stay on its fastest links, and `host_shard` splits a
request stream round-robin over the ranks.

`spawn` starts the ranks of a world on this host and joins them within a
deadline, killing the survivors when one fails or the deadline passes: the
tests, the serve CLI's workers and `chip_smoke.py` start their ranks
through it or through the CLI.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0


def local_world_size(world_size: int | None = None) -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE where a launcher set it, else
    the whole world (one host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if world_size is not None:
        return world_size
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank(rank: int | None = None) -> int:
    """This rank's index on its host: LOCAL_RANK where a launcher set it,
    else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: cuda:(local rank % cards) for "cuda", else the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def choose_backend(device="cuda", world_size: int | None = None) -> str:
    """NCCL when every rank of this host has a card of its own, gloo when
    ranks share a card or run on the CPU."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= local_world_size(
            world_size):
        return "nccl"
    return "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda", backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the process group (a no-op when it is up). With no
    arguments, torch.distributed's environment (`env://`: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) names the world; arguments override it
    (`file://` or `tcp://localhost:port` init methods). The backend taken is
    printed once, on stderr."""
    if dist.is_initialized():
        return
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    me = rank if rank is not None else int(os.environ.get("RANK", "0"))
    backend = backend or choose_backend(device, world)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=me, timeout=datetime.timedelta(seconds=timeout_s))
    if me == 0:
        where = local_device(device, me) if torch.device(device).type == "cuda" else "cpu"
        share = " (ranks share the card)" if (backend == "gloo" and str(where) != "cpu") else ""
        print(f"llamavk: torch.distributed backend {backend}, {world} ranks, rank 0 on "
              f"{where}{share}", file=sys.stderr, flush=True)


def shutdown() -> None:
    """Tear the process group down (a no-op when it is not up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices_first() -> list[int]:
    """The world's ranks with this host's first (the mesh's device order:
    tp axes then lie over one host's ranks). One process: [0]."""
    if not dist.is_initialized():
        return [0]
    hosts: list = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    mine = hosts[dist.get_rank()]
    local = [r for r, h in enumerate(hosts) if h == mine]
    return local + [r for r in range(len(hosts)) if r not in local]


def host_shard(items: list, process_id: int | None = None) -> list:
    """Round-robin shard of a request list over the ranks: items[rank::world]
    (the identity in a single process)."""
    pid = process_index() if process_id is None else process_id
    return items[pid :: max(process_count(), 1)]


def spawn(fn, nprocs: int, args: tuple = (), deadline_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes (the `spawn` start
    method: fn and args must pickle) and join them within `deadline_s`.
    Raises RuntimeError naming the first rank that failed, or TimeoutError;
    either way every process still alive is killed first."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, *args), daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None or time.monotonic() > end:
                break
            time.sleep(0.05)
        failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), failed)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in procs:
            p.join(5)
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {nprocs} exited with code {procs[failed].exitcode}")
    if alive:
        raise TimeoutError(f"{len(alive)} of {nprocs} ranks still running after {deadline_s} s")

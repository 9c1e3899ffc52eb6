"""The port's `parallel/multihost.py`: single-process semantics, and a
two-process gloo world on the CPU (rendezvous through a file) that brings
the group up, splits a request list, runs one cross-process all-reduce and
tears down cleanly, as tests/test_multihost.py does for the JAX package."""

from __future__ import annotations

import time

import pytest
import torch
import torch.distributed as dist

from llamavk_tpu_torch.parallel import multihost

DEADLINE_S = 60


def _rank(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, device="cpu", timeout_s=30)
    multihost.initialize(init, world, rank, device="cpu")  # idempotent
    assert multihost.process_count() == world and multihost.process_index() == rank
    items = list(range(10))
    mine = multihost.host_shard(items)
    other = multihost.host_shard(items, process_id=1 - rank)
    assert sorted(mine + other) == items and mine == items[rank::world]
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) * (rank + 1)
    dist.all_reduce(x)
    order = multihost.local_devices_first()
    torch.save(dict(sum=x, order=order), f"{out}.{rank}")
    multihost.shutdown()
    assert not dist.is_initialized()


def _sleeper(rank: int) -> None:
    time.sleep(60 if rank else 0)


def _failer(rank: int) -> None:
    raise SystemExit(3 if rank else 0)


def test_single_process_semantics():
    items = list(range(10))
    assert multihost.host_shard(items) == items  # 1 process -> everything
    assert multihost.host_shard(items, process_id=1) == items[1::1]
    assert multihost.local_devices_first() == [0]
    assert multihost.choose_backend("cpu") == "gloo"
    multihost.shutdown()  # no-op when not initialized


def test_two_process_world(tmp_path):
    multihost.spawn(_rank, 2, (2, f"file://{tmp_path}/init", str(tmp_path / "res")),
                    deadline_s=DEADLINE_S)
    want = torch.arange(8, dtype=torch.float32).reshape(2, 4) * 3  # 1x + 2x
    for r in range(2):
        res = torch.load(tmp_path / f"res.{r}")
        assert torch.equal(res["sum"], want)
        assert res["order"][0] == 0 and sorted(res["order"]) == [0, 1]  # one host


def test_spawn_deadline_and_failure():
    """A rank that hangs past the deadline, or one that fails, ends the
    world: the survivors are killed and the caller gets an error."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        multihost.spawn(_sleeper, 2, deadline_s=3)
    with pytest.raises(RuntimeError, match="rank 1 of 2"):
        multihost.spawn(_failer, 2, deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 30

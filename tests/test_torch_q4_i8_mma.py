"""K5's launch plan on the CPU: the K split and the partials' scratch are the
same for every M of the int8 dot (1 to 64), so an output row's float order
does not depend on how many rows share its batch; the kernel variant (token
tiles) is a function of M alone and takes every M the route sends to K5;
the K5 timing script refuses to start without CUDA. The kernel itself runs
on the card (`chip_smoke.py`)."""

import pytest
import torch

from llamavk_tpu_torch.ops import q4_matmul as q4
from llamavk_tpu_torch.ops.qweight import QWeight
from llamavk_tpu_torch.tools import bench_i8

# the 7B matmuls (K, N), a tp = 2 rank's, and the tiny model's
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096), (128, 384), (256, 128)]
MS = range(1, q4.I8_MAX_B + 1)


def _weight(k: int, n: int) -> QWeight:
    return QWeight(packed=torch.zeros((k // 2, n), dtype=torch.int8),
                   scales=torch.zeros((k // 32, n), dtype=torch.bfloat16))


@pytest.mark.parametrize("k,n", SHAPES)
def test_i8_split_independent_of_m(k, n):
    """One K split and a [splits, M, N] scratch for every M; each split a
    range of whole groups, at least 16 of them where K has 16."""
    splits = {q4.i8_splits(k, n) for m in MS}
    assert len(splits) == 1
    split = splits.pop()
    g = k // 32
    assert 1 <= split <= max(1, g // 16)
    gps = -(-g // q4.ksplit_i8(k, n))
    assert -(-g // gps) == split and (split == 1 or gps >= 16)
    for m in MS:
        assert q4.i8_scratch_shape(m, k, n) == (None if split == 1 else (split, m, n))


def test_i8_split_7b():
    """The 7B splits: about two 256-column blocks an SM of a 132-SM card."""
    assert [q4.i8_splits(k, n) for k, n in SHAPES[:5]] == [6, 8, 3, 17, 2]


@pytest.mark.parametrize("k,n", SHAPES)
def test_i8_variant_takes_every_routed_m(k, n):
    """The token-tile variant depends on M alone, holds the M rows, is the
    fewest tiles that do, and exists for every M that `i8_route` sends to
    K5 (w2 at 7B: M <= 16; the other shapes: M <= 64)."""
    qw = _weight(k, n)
    routed = [m for m in MS if q4.i8_route("i8", m, k, n, qw)]
    assert routed == list(range(1, routed[-1] + 1))
    for m in routed:
        t = q4.i8_token_tiles(m)
        assert t in q4.I8_TILES and m <= 8 * t and (t == 1 or m > 4 * t)
    if (k, n) == (11008, 4096):
        assert routed[-1] == 16
    elif k <= 4096:
        assert routed[-1] == q4.I8_MAX_B


def test_i8_variant_refuses_past_the_cap():
    for m in (0, q4.I8_MAX_B + 1):
        with pytest.raises(ValueError):
            q4.i8_token_tiles(m)


def test_bench_i8_refuses_without_cuda(monkeypatch):
    """The K5 timing script times CUDA kernels: without CUDA it refuses to
    start. It covers K5's two scale planes, the five 7B shapes and
    M = 1 ... 64."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        bench_i8.main([])
    assert bench_i8.MODES == ("bf16 scales", "f32 scales")
    assert bench_i8.MS == (1, 2, 4, 8, 16, 32, 64)
    assert set(bench_i8.SHAPES) == {"wqkv", "wo", "w13", "w2", "output"}

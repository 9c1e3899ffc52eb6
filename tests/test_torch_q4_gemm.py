"""K1's GEMM (M >= 2) split rule and scratch, and the GEMM timing script, on
the CPU: the K split of the M <= 64 route is a function of (K, N) and the
card's SM count alone, so an output row's float order does not depend on how
many rows share its batch; above, the 128 x 128 tiles split K only while
they leave SMs idle. The kernels themselves run on the card
(`chip_smoke.py`)."""

import pytest
import torch

from llamavk_tpu_torch.ops import q4_matmul as q4
from llamavk_tpu_torch.tools import bench_gemm

# the 7B matmuls (K, N) and a tp = 2 rank's, and the tiny model's
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096), (128, 384)]
SMS = (132, 114, 66)


@pytest.mark.parametrize("k,n", SHAPES)
def test_gemm_split_independent_of_m(k, n):
    """Every M of the split-K route (2..64) takes one split count and a
    scratch of [splits, M, N], for each SM count; the split keeps at least
    16 units (512 k) a range and at most ~2 blocks an SM."""
    for sms in SMS:
        splits = {q4.gemm_ksplit(m, k, n, sms) for m in range(2, q4.GEMM_SMALL_M + 1)}
        assert len(splits) == 1
        split = splits.pop()
        assert 1 <= split <= max(1, k // 32 // 16)
        assert split <= -(-2 * sms // -(-n // q4.GEMM_SMALL_BN))
        for m in (2, 4, 32, 64):
            want = None if split == 1 else (split, m, n)
            assert q4.scratch_shape(m, k, n, sms) == want


def test_gemm_split_follows_shape_and_card():
    """The split grows with K and with the SM count, and shrinks with N."""
    assert q4.gemm_ksplit(4, 11008, 4096, 132) > q4.gemm_ksplit(4, 4096, 12288, 132)
    assert q4.gemm_ksplit(4, 4096, 4096, 132) > q4.gemm_ksplit(4, 4096, 4096, 33)
    assert q4.gemm_ksplit(4, 4096, 32000, 132) <= q4.gemm_ksplit(4, 4096, 12288, 132)


@pytest.mark.parametrize("m,k,n,want", [(1024, 4096, 12288, 1), (512, 4096, 22016, 1),
                                        (353, 4096, 4096, 3), (512, 4096, 4096, 3),
                                        (1024, 4096, 4096, 1), (65, 11008, 4096, 9)])
def test_gemm_split_large_m(m, k, n, want):
    """Above M = 64 the split depends on the grid of 128 x 128 tiles: one
    range once they cover the 132 SMs, else about two blocks an SM."""
    assert q4.gemm_ksplit(m, k, n, 132) == want
    assert q4.scratch_shape(m, k, n, 132) == (None if want == 1 else (want, m, n))


def test_gemv_split_one_wave_at_7b_shapes():
    """The decode GEMV's split (M = 1) at the 7B shapes on 132 SMs: the
    most splits whose blocks (128 columns each) all fit on the card at once
    (4 an SM), whole units a split, scratch [splits, N] for the merge inside
    the launch; and the GEMM's split rule is unchanged by it."""
    assert [q4.gemv_ksplit(k, n, 132) for k, n in SHAPES[:5]] == [5, 16, 3, 16, 2]
    assert [q4.gemv_splits(k, n, 132) for k, n in SHAPES[:5]] == [5, 16, 3, 16, 2]
    assert q4.scratch_shape(1, 4096, 4096, 132) == (16, 4096)
    assert q4.scratch_shape(2, 4096, 4096, 132) == (8, 2, 4096)


def test_bench_gemm_refuses_without_cuda(monkeypatch):
    """The GEMM timing script times CUDA kernels: without CUDA it refuses to
    start; its modes are K1's ten."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="GPU"):
        bench_gemm.main([])
    assert len(bench_gemm.MODES) == len(set(bench_gemm.MODES)) == 10

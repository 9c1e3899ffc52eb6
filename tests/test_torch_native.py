"""The port's native host library (`llamavk_tpu_torch/native.py` over
`native/llamavk_native.cpp`, built with g++ into build/) against the port's
NumPy functions of `formats/` on the same inputs (the contracts of
tests/test_native.py): quantize, dequantize, fp16 and the repack in both
layouts byte for byte, the tokenizer; and the callers that take the library
(the loader, `CheckpointReader.load_f32`, the quantize CLI, the Tokenizer)
giving identical results with LLAMAVK_NO_NATIVE=1 and without it."""

import dataclasses

import numpy as np
import pytest
import torch

from llamavk_tpu_torch import native
from llamavk_tpu_torch.cli.quantize import quantize_file
from llamavk_tpu_torch.formats.ggml_io import (
    CheckpointReader,
    CheckpointWriter,
    Hparams,
    TokenEntry,
)
from llamavk_tpu_torch.formats.q4 import (
    GGML_FTYPE_F16,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    QK,
    q4_0_to_bytes,
    q4_1_to_bytes,
    quantize_q4_0,
    quantize_q4_1,
)
from llamavk_tpu_torch.formats.q4 import quantize_tensor_with_hist as quantize_ref
from llamavk_tpu_torch.formats.repack import repack_q4_0, repack_q4_1
from llamavk_tpu_torch.models import loader as tl


@pytest.fixture(scope="module")
def lib():
    """The built library: g++ is part of this repository's toolchain, so a
    missing library is a failure, not a skip."""
    lib = native.get_lib()
    assert lib is not None, "the native library did not build"
    assert lib._name.startswith(str(native.BUILD_DIR))  # nothing built into native/
    return lib


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("ftype", [GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1])
def test_quantize_matches_numpy(lib, rng, ftype):
    x = rng.standard_normal((64, 256)).astype(np.float32) * 0.3
    x[0, :QK] = 0.0  # an all-zero block (d == 0)
    x[1, :QK] = 1e30  # a huge one
    data_n, hist_n = native.quantize_tensor_with_hist(x, ftype)
    data_r, hist_r = quantize_ref(x, ftype)
    assert data_n == data_r
    np.testing.assert_array_equal(hist_n, hist_r)


@pytest.mark.parametrize("ftype", [GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1])
def test_dequantize_and_fp16_match_numpy(lib, rng, ftype):
    n = 8 * 1024
    x = rng.standard_normal(n).astype(np.float32)
    if ftype == GGML_FTYPE_Q4_0:
        d, q = quantize_q4_0(x)
        raw = q4_0_to_bytes(d, q)
        ref = ((q.astype(np.float32) - 8.0) * d[:, None]).reshape(-1)
    else:
        d, m, q = quantize_q4_1(x)
        raw = q4_1_to_bytes(d, m, q)
        ref = (q.astype(np.float32) * d[:, None] + m[:, None]).reshape(-1)
    out = native.dequantize_stream(np.frombuffer(raw, np.uint8), n, ftype)
    np.testing.assert_array_equal(out, ref)  # Q4_1's q * d + m built without FMA contraction
    all_u16 = np.arange(65536, dtype=np.uint16)  # every fp16 pattern
    got, want = native.fp16_to_fp32(all_u16), all_u16.view(np.float16).astype(np.float32)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[finite], want[finite])
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("layout", ["ilv", "lin"])
@pytest.mark.parametrize("ftype", [GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1])
def test_repack_matches_numpy(lib, rng, layout, ftype):
    """Disk blocks to device planes, both layouts, one chunk and two (K
    per chunk a multiple of 64), and the embedding rows."""
    n_rows, k = 48, 256
    x = rng.standard_normal((n_rows, k)).astype(np.float32)
    if ftype == GGML_FTYPE_Q4_0:
        d, q = quantize_q4_0(x)
        raw = np.frombuffer(q4_0_to_bytes(d, q), np.uint8)
    else:
        d, m, q = quantize_q4_1(x)
        raw = np.frombuffer(q4_1_to_bytes(d, m, q), np.uint8)
    for chunks in (1, 2):
        ref = (repack_q4_0(d, q, layout=layout, chunks=chunks) if ftype == GGML_FTYPE_Q4_0
               else repack_q4_1(d, m, q, layout=layout, chunks=chunks))
        got = native.repack_q4_stream(raw, n_rows, k, ftype, layout, chunks)
        np.testing.assert_array_equal(got.packed, ref.packed)
        np.testing.assert_array_equal(got.scales, ref.scales)
        if ftype == GGML_FTYPE_Q4_0:
            assert got.bias is None and ref.bias is None
        else:
            np.testing.assert_allclose(got.bias, ref.bias, rtol=1e-6)
        assert (got.k, got.n, got.layout, got.chunks) == (k, n_rows, layout, chunks)
    if ftype == GGML_FTYPE_Q4_0 and layout == "ilv":
        packed, scales, bias = native.repack_q4_rows_stream(raw, n_rows, k, ftype)
        qs = (q.astype(np.int16) - 8).astype(np.int8).reshape(n_rows, k)
        np.testing.assert_array_equal(packed, tl._pack_embedding_rows(qs))
        np.testing.assert_array_equal(scales, d)
        assert bias is None


def test_tokenizer_matches_python(lib, tmp_path, monkeypatch):
    """The C++ greedy bigram merge gives the port's Python tokenizer's ids,
    and the Tokenizer takes it where it builds."""
    path = str(tmp_path / "tiny.bin")
    tl.random_tiny_model(write_path=path, quantize=True)
    vocab = CheckpointReader(path).vocab
    fast = native.make_tokenizer([t.text for t in vocab], [t.score for t in vocab])
    wired = tl.Tokenizer(vocab)
    wired.encode("x")  # builds its native handle (lazily, on the first encode)
    monkeypatch.setenv("LLAMAVK_NO_NATIVE", "1")
    py = tl.Tokenizer(vocab)
    for text in ("hello world", "<t5><t9>", "", "é中 x", "a" * 300):
        data = text.encode()
        assert fast.encode(data) == py.encode(data, bos=False)
        assert wired.encode(data) == py.encode(data)
    assert wired._native is not None and py._native is None


@pytest.mark.parametrize("ftype", [GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1])
def test_quantize_cli_native_vs_numpy(lib, tmp_path, monkeypatch, ftype):
    """The quantize CLI writes the same file through the native quantizer
    and, with LLAMAVK_NO_NATIVE=1, the NumPy one."""
    f32 = str(tmp_path / "tiny-f32.bin")
    tl.random_tiny_model(write_path=f32, quantize=False)
    quantize_file(f32, str(tmp_path / "native.bin"), ftype, verbose=False)
    monkeypatch.setenv("LLAMAVK_NO_NATIVE", "1")
    quantize_file(f32, str(tmp_path / "numpy.bin"), ftype, verbose=False)
    assert (tmp_path / "native.bin").read_bytes() == (tmp_path / "numpy.bin").read_bytes()


@pytest.mark.parametrize("ftype", [GGML_FTYPE_F16, GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1])
def test_load_f32_native_vs_numpy(lib, rng, tmp_path, monkeypatch, ftype):
    """CheckpointReader.load_f32 widens f16 and dequantizes q4 through the
    native library, and gives NumPy's bytes (LLAMAVK_NO_NATIVE=1)."""
    x = rng.standard_normal((48, 256)).astype(np.float32)
    path = tmp_path / "t.bin"
    vocab = [TokenEntry(b"a", 0.0)]
    hp = Hparams(n_vocab=1, n_embd=256, n_mult=32, n_head=2, n_layer=1, n_rot=128, ftype=ftype)
    with CheckpointWriter(str(path), hp, vocab) as w:
        if ftype == GGML_FTYPE_F16:
            w.write_array("w.weight", x.astype(np.float16))
        else:
            w.write_tensor("w.weight", (256, 48), ftype, quantize_ref(x, ftype)[0])
    calls = []
    for name in ("fp16_to_fp32", "dequantize_stream"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, fn=fn: calls.append(1) or fn(*a))
    a = CheckpointReader(str(path)).load_f32("w.weight")
    assert calls and a.shape == x.shape and a.dtype == np.float32
    monkeypatch.setenv("LLAMAVK_NO_NATIVE", "1")
    b = CheckpointReader(str(path)).load_f32("w.weight")
    assert a.tobytes() == b.tobytes()


def _flat(params) -> dict:
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in _flat(v).items()})
    return out


def test_loader_native_vs_numpy(lib, tmp_path, monkeypatch):
    """Whole checkpoints, Q4_0 and Q4_1, load into identical params in
    both layouts through the native repack and, with LLAMAVK_NO_NATIVE=1,
    the NumPy one."""
    f32 = str(tmp_path / "tiny-f32.bin")
    tl.random_tiny_model(write_path=f32, quantize=False)
    repack = native.repack_q4_stream
    calls = []
    monkeypatch.setattr(native, "repack_q4_stream",
                        lambda *a, **k: calls.append(1) or repack(*a, **k))
    for ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        path = str(tmp_path / f"tiny-{ftype}.bin")
        quantize_file(f32, path, ftype, verbose=False)
        for layout in ("ilv", "lin"):
            monkeypatch.delenv("LLAMAVK_NO_NATIVE", raising=False)
            calls.clear()
            a = _flat(tl.load_model(path, device="cpu", layout=layout)[1])
            assert calls and native.get_lib() is not None
            monkeypatch.setenv("LLAMAVK_NO_NATIVE", "1")
            assert native.get_lib() is None
            b = _flat(tl.load_model(path, device="cpu", layout=layout)[1])
            assert sorted(a) == sorted(b)
            for key in a:
                assert torch.equal(a[key], b[key]), (ftype, layout, key)

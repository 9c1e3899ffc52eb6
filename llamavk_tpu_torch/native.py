"""ctypes bindings for the native host data-plane library (twin of
`llamavk_tpu/native.py`).

The host hot paths of model loading and quantization (the q4 codecs and the
f16 widening behind `CheckpointReader.load_f32`, the quantize CLI's
quantizer, the disk-block to device-plane repack of the loader, the greedy
bigram tokenizer) live in C++ in `native/llamavk_native.cpp`. This module compiles that source with g++
into `build/llamavk_tpu_torch/` at the repository root on first use (named by
a hash of the source and the flags; nothing is written into `native/`),
loads it, and every wrapper has a NumPy fallback with the same bytes, so the
package works (slower) without a compiler. Host code only: no device or kernel is
involved on either path.

Set LLAMAVK_NO_NATIVE=1 to force the NumPy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _REPO_ROOT / "native" / "llamavk_native.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "llamavk_tpu_torch"
# native/Makefile's flags, -march=native where the compiler takes it, and no
# contraction of a * b + c into one FMA, so that every wrapper gives the NumPy
# fallback's bytes (Q4_1's dequantization is q * d + m)
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared",
            "-ffp-contract=off"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_c_i64 = ctypes.c_int64
_c_int = ctypes.c_int
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _flags(cxx: str) -> tuple[list[str], str]:
    """The compiler flags, and the target -march=native resolves to on this
    host (part of the library's name, so a build directory carried to
    another CPU is not reused there)."""
    probe = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                           text=True)
    if probe.returncode != 0:
        return CXXFLAGS, ""
    return CXXFLAGS + ["-march=native"], probe.stdout


def _build() -> Path | None:
    """The built library's path (compiling it when it is missing), or None
    where there is no source or no compiler, or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not SOURCE.exists():
        return None
    try:
        flags, target = _flags(cxx)
        h = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()
                           + target.encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libllamavk_native_{h}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        return out
    except (subprocess.SubprocessError, OSError):
        return None


def _declare(lib: ctypes.CDLL) -> None:
    lib.lvk_version.restype = _c_int
    lib.lvk_hardware_threads.restype = _c_int
    lib.lvk_quantize_q4_0.restype = _c_i64
    lib.lvk_quantize_q4_0.argtypes = [_p_f32, _c_i64, _p_u8, ctypes.c_void_p, _c_int]
    lib.lvk_quantize_q4_1.restype = _c_i64
    lib.lvk_quantize_q4_1.argtypes = [_p_f32, _c_i64, _p_u8, ctypes.c_void_p, _c_int]
    lib.lvk_dequantize_q4_0.argtypes = [_p_u8, _c_i64, _p_f32, _c_int]
    lib.lvk_dequantize_q4_1.argtypes = [_p_u8, _c_i64, _p_f32, _c_int]
    lib.lvk_fp16_to_fp32.argtypes = [_p_u16, _c_i64, _p_f32, _c_int]
    lib.lvk_repack_q4.argtypes = [
        _p_u8, _c_i64, _c_i64, _c_int, _c_int, _c_int,
        _p_i8, _p_f32, ctypes.c_void_p, _c_int,
    ]
    lib.lvk_repack_q4_rows.argtypes = [
        _p_u8, _c_i64, _c_i64, _c_int,
        _p_i8, _p_f32, ctypes.c_void_p, _c_int,
    ]
    lib.lvk_tokenizer_create.restype = ctypes.c_void_p
    lib.lvk_tokenizer_create.argtypes = [_p_u8, _p_i64, _p_f32, _c_i64]
    lib.lvk_tokenizer_free.argtypes = [ctypes.c_void_p]
    lib.lvk_tokenize.restype = _c_i64
    lib.lvk_tokenize.argtypes = [ctypes.c_void_p, _p_u8, _c_i64, _p_i32, _c_i64]
    lib.lvk_mmap_open.restype = ctypes.c_void_p
    lib.lvk_mmap_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_c_i64)]
    lib.lvk_mmap_close.argtypes = [ctypes.c_void_p, _c_i64]


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (unavailable / disabled)."""
    global _lib, _tried
    if os.environ.get("LLAMAVK_NO_NATIVE"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            if lib.lvk_version() != 1:
                return None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# quantize / dequantize (byte-stream form, matching formats/q4.py)

from .formats.q4 import (  # noqa: E402  (import after helpers to avoid cycle)
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    Q4_0_BLOCK_BYTES,
    Q4_1_BLOCK_BYTES,
    QK,
)


def quantize_tensor_with_hist(x: np.ndarray, ftype: int) -> tuple[bytes, np.ndarray]:
    """Native-accelerated equivalent of formats.q4.quantize_tensor_with_hist."""
    lib = get_lib()
    if lib is None:
        from .formats.q4 import quantize_tensor_with_hist as ref

        return ref(x, ftype)
    flat = np.ascontiguousarray(x.reshape(-1), np.float32)
    n = flat.size
    nb = n // QK
    hist = np.zeros(16, np.int64)
    if ftype == GGML_FTYPE_Q4_0:
        out = np.empty(nb * Q4_0_BLOCK_BYTES, np.uint8)
        lib.lvk_quantize_q4_0(flat, n, out, hist.ctypes.data, 0)
    elif ftype == GGML_FTYPE_Q4_1:
        out = np.empty(nb * Q4_1_BLOCK_BYTES, np.uint8)
        lib.lvk_quantize_q4_1(flat, n, out, hist.ctypes.data, 0)
    else:
        raise ValueError(f"not a q4 ftype: {ftype}")
    return out.tobytes(), hist


def dequantize_stream(raw: np.ndarray, n: int, ftype: int) -> np.ndarray | None:
    """Block stream → f32[n]; None if native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(np.frombuffer(raw, np.uint8) if isinstance(raw, bytes) else raw)
    out = np.empty(n, np.float32)
    if ftype == GGML_FTYPE_Q4_0:
        lib.lvk_dequantize_q4_0(raw, n, out, 0)
    elif ftype == GGML_FTYPE_Q4_1:
        lib.lvk_dequantize_q4_1(raw, n, out, 0)
    else:
        return None
    return out


def fp16_to_fp32(raw_u16: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    raw_u16 = np.ascontiguousarray(raw_u16, np.uint16)
    out = np.empty(raw_u16.size, np.float32)
    lib.lvk_fp16_to_fp32(raw_u16, raw_u16.size, out, 0)
    return out


# ---------------------------------------------------------------------------
# repack: disk q4 block stream → device planes (see formats/repack.py contract)


def repack_q4_stream(
    raw: np.ndarray,
    n_rows: int,
    row_elems: int,
    ftype: int,
    layout: str = "ilv",
    chunks: int = 1,
):
    """Native single-pass repack. Returns PackedQ4 or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from .formats.repack import PackedQ4

    k, n = row_elems, n_rows
    g = k // QK
    is_q41 = 1 if ftype == GGML_FTYPE_Q4_1 else 0
    raw = np.ascontiguousarray(np.frombuffer(raw, np.uint8) if isinstance(raw, bytes) else raw)
    packed = np.empty((k // 2, n), np.int8)
    scales = np.empty((g, n), np.float32)
    bias = np.empty((g, n), np.float32) if is_q41 else None
    lib.lvk_repack_q4(
        raw, n, k, is_q41, 0 if layout == "ilv" else 1, chunks,
        packed, scales, bias.ctypes.data if is_q41 else None, 0,
    )
    return PackedQ4(
        packed=packed, scales=scales, bias=bias, k=k, n=n, layout=layout, chunks=chunks
    )


def repack_q4_rows_stream(raw: np.ndarray, n_rows: int, row_elems: int, ftype: int):
    """Embedding-table repack → (packed [V,K/2] i8, scales [V,G], bias|None)."""
    lib = get_lib()
    if lib is None:
        return None
    k = row_elems
    g = k // QK
    is_q41 = 1 if ftype == GGML_FTYPE_Q4_1 else 0
    raw = np.ascontiguousarray(np.frombuffer(raw, np.uint8) if isinstance(raw, bytes) else raw)
    packed = np.empty((n_rows, k // 2), np.int8)
    scales = np.empty((n_rows, g), np.float32)
    bias = np.empty((n_rows, g), np.float32) if is_q41 else None
    lib.lvk_repack_q4_rows(
        raw, n_rows, k, is_q41, packed, scales,
        bias.ctypes.data if is_q41 else None, 0,
    )
    return packed, scales, bias


class NativeTokenizer:
    """Handle to the C++ greedy bigram-merge tokenizer (bit-identical twin of
    tokenizer.py — tests/test_torch_native.py cross-checks)."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._handle = handle

    def encode(self, data: bytes) -> list[int] | None:
        if not data:
            return []
        buf = np.frombuffer(data, np.uint8)
        cap = len(data) + 8
        out = np.empty(cap, np.int32)
        m = self._lib.lvk_tokenize(
            self._handle, buf, len(data), out, cap
        )
        if m < 0:
            return None  # capacity overflow (cannot happen: <= 1 id/byte)
        return out[:m].tolist()

    def __del__(self):
        try:
            if self._handle:
                self._lib.lvk_tokenizer_free(self._handle)
        except Exception:
            pass


def make_tokenizer(texts: list[bytes], scores) -> "NativeTokenizer | None":
    """Build a native tokenizer from vocab pieces + scores, or None."""
    lib = get_lib()
    if lib is None:
        return None
    blob = b"".join(texts) or b"\x00"
    offsets = np.zeros(len(texts) + 1, np.int64)
    np.cumsum([len(t) for t in texts], out=offsets[1:])
    handle = lib.lvk_tokenizer_create(
        np.frombuffer(blob, np.uint8), offsets,
        np.ascontiguousarray(scores, np.float32), len(texts),
    )
    if not handle:
        return None
    return NativeTokenizer(lib, handle)

"""ggml-style block quantization codecs (Q4_0 / Q4_1), NumPy reference.

Bit-exact re-implementation of the behavior of the reference quantizers
(`ggml.c:509-545` quantize_row_q4_0_reference, `ggml.c:800-838`
quantize_row_q4_1_reference, dequant at `ggml.c:962,1080`), written
independently in vectorized NumPy. These are the "reference scalar
implementation kept next to every optimized kernel" in the sense of the
reference's test strategy — the Pallas device kernels are parity-tested
against values produced here.

Format (matching `ggml.c:416,492-506`):
  QK = 32 elements per block.
  Q4_0 block: f32 scale d, 16 bytes of nibbles.  value = (q - 8) * d,
              d = max(|x|)/7, q = roundf(x/d) + 8  (round half away from zero).
  Q4_1 block: f32 scale d, f32 min m, 16 bytes of nibbles.  value = q*d + m,
              d = (max - min)/15, q = roundf((x - m)/d).
  Nibble packing on disk: byte i holds element 2i in the low nibble and
  element 2i+1 in the high nibble.

Copy of `llamavk_tpu/formats/q4.py` (pure NumPy): the port keeps its own so
that it imports nothing from the JAX package.
"""

from __future__ import annotations

import numpy as np

QK = 32  # block size, ggml.c:416

# ggml ftype / quantization type codes (llama.h enum llama_ftype order)
GGML_FTYPE_F32 = 0
GGML_FTYPE_F16 = 1
GGML_FTYPE_Q4_0 = 2
GGML_FTYPE_Q4_1 = 3

Q4_0_BLOCK_BYTES = 4 + QK // 2   # f32 d + 16 nibble bytes = 20
Q4_1_BLOCK_BYTES = 8 + QK // 2   # f32 d + f32 m + 16 nibble bytes = 24


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero (np.round rounds half to even)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantize_q4_0(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a float array (last dim divisible by QK) to Q4_0.

    Returns (d, q): d f32 [..., nb], q uint8 raw nibbles in [0,15] [..., nb, QK].
    """
    x = np.asarray(x, dtype=np.float32)
    assert x.shape[-1] % QK == 0, x.shape
    xb = x.reshape(*x.shape[:-1], -1, QK)
    amax = np.abs(xb).max(axis=-1)
    d = (amax / 7.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0))
    q = _roundf(xb * inv_d[..., None]).astype(np.int8) + 8
    q = np.clip(q, 0, 15).astype(np.uint8)
    return d, q


def dequantize_q4_0(d: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Inverse of quantize_q4_0 → f32 [..., nb*QK]."""
    out = (q.astype(np.float32) - 8.0) * np.asarray(d, np.float32)[..., None]
    return out.reshape(*out.shape[:-2], -1)


def quantize_q4_1(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize to Q4_1. Returns (d, m, q) with q uint8 in [0,15]."""
    x = np.asarray(x, dtype=np.float32)
    assert x.shape[-1] % QK == 0, x.shape
    xb = x.reshape(*x.shape[:-1], -1, QK)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = ((mx - mn) / 15.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0))
    q = _roundf((xb - mn[..., None]) * inv_d[..., None])
    q = np.clip(q, 0, 15).astype(np.uint8)
    return d, mn.astype(np.float32), q


def dequantize_q4_1(d: np.ndarray, m: np.ndarray, q: np.ndarray) -> np.ndarray:
    out = q.astype(np.float32) * np.asarray(d, np.float32)[..., None] + np.asarray(
        m, np.float32
    )[..., None]
    return out.reshape(*out.shape[:-2], -1)


def _pack_nibble_pairs(q: np.ndarray) -> np.ndarray:
    """[..., nb, QK] uint8 nibbles → [..., nb, QK//2] bytes (even=low, odd=high)."""
    lo = q[..., 0::2]
    hi = q[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def _unpack_nibble_pairs(b: np.ndarray) -> np.ndarray:
    """[..., nb, QK//2] bytes → [..., nb, QK] uint8 nibbles."""
    lo = b & 0xF
    hi = b >> 4
    out = np.empty(b.shape[:-1] + (b.shape[-1] * 2,), dtype=np.uint8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


def q4_0_to_bytes(d: np.ndarray, q: np.ndarray) -> bytes:
    """Serialize to the on-disk block stream: per block f32 d then 16 bytes."""
    nb = d.size
    packed = _pack_nibble_pairs(q.reshape(nb, QK))
    out = np.empty((nb, Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :4] = np.asarray(d, np.float32).reshape(nb, 1).view(np.uint8)
    out[:, 4:] = packed
    return out.tobytes()


def q4_0_from_bytes(buf: bytes | np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse n elements worth of Q4_0 blocks → (d [nb], q [nb, QK])."""
    nb = n // QK
    raw = np.frombuffer(buf, dtype=np.uint8, count=nb * Q4_0_BLOCK_BYTES).reshape(
        nb, Q4_0_BLOCK_BYTES
    )
    d = raw[:, :4].copy().view(np.float32).reshape(nb)
    q = _unpack_nibble_pairs(raw[:, 4:])
    return d, q


def q4_1_to_bytes(d: np.ndarray, m: np.ndarray, q: np.ndarray) -> bytes:
    nb = d.size
    packed = _pack_nibble_pairs(q.reshape(nb, QK))
    out = np.empty((nb, Q4_1_BLOCK_BYTES), dtype=np.uint8)
    out[:, :4] = np.asarray(d, np.float32).reshape(nb, 1).view(np.uint8)
    out[:, 4:8] = np.asarray(m, np.float32).reshape(nb, 1).view(np.uint8)
    out[:, 8:] = packed
    return out.tobytes()


def q4_1_from_bytes(
    buf: bytes | np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    nb = n // QK
    raw = np.frombuffer(buf, dtype=np.uint8, count=nb * Q4_1_BLOCK_BYTES).reshape(
        nb, Q4_1_BLOCK_BYTES
    )
    d = raw[:, :4].copy().view(np.float32).reshape(nb)
    m = raw[:, 4:8].copy().view(np.float32).reshape(nb)
    q = _unpack_nibble_pairs(raw[:, 8:])
    return d, m, q


def ftype_row_bytes(ftype: int, n: int) -> int:
    """Bytes occupied by n elements of the given ggml ftype (n % QK == 0 for q4)."""
    if ftype == GGML_FTYPE_F32:
        return 4 * n
    if ftype == GGML_FTYPE_F16:
        return 2 * n
    if ftype == GGML_FTYPE_Q4_0:
        return (n // QK) * Q4_0_BLOCK_BYTES
    if ftype == GGML_FTYPE_Q4_1:
        return (n // QK) * Q4_1_BLOCK_BYTES
    raise ValueError(f"unknown ftype {ftype}")


def quantize_tensor_with_hist(
    x: np.ndarray, ftype: int
) -> tuple[bytes, np.ndarray]:
    """Quantize a 2-D f32 tensor to a q4 byte stream + 16-bucket nibble histogram.

    Equivalent surface to ggml_quantize_q4_0/_q4_1 (ggml.c:10520-10570) as used
    by the model quantizer (llama.cpp:1465-1577).
    """
    if ftype == GGML_FTYPE_Q4_0:
        d, q = quantize_q4_0(x.reshape(-1))
        data = q4_0_to_bytes(d, q)
    elif ftype == GGML_FTYPE_Q4_1:
        d, m, q = quantize_q4_1(x.reshape(-1))
        data = q4_1_to_bytes(d, m, q)
    else:
        raise ValueError(f"not a q4 ftype: {ftype}")
    hist = np.bincount(q.reshape(-1), minlength=16).astype(np.int64)
    return data, hist

"""GGML / GGMF / GGJT checkpoint file IO.

Re-implements the reference's file-format surface (reader behavior of
`llama.cpp:319-418` llama_file_loader, multi-part shard merging of
`llama.cpp:255-313,607-652`, and the writer behavior of `llama.cpp:420-474`
llama_file_saver) in NumPy, so existing ggml-model-*.bin checkpoints load
directly and quantized models we write are readable by the C reference.

Layout (little-endian):
  magic u32: 'ggml' (0x67676d6c, v0, no version field, no vocab scores),
             'ggmf' (0x67676d66, + version u32 == 1, vocab scores),
             'ggjt' (0x67676a74, + version u32 == 1, scores, 32B-aligned data).
  hparams: 7 x u32 — n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype.
  vocab:   n_vocab x { len u32, bytes[len], score f32 (not in 'ggml' v0) }.
  tensors: repeated { n_dims u32, name_len u32, ftype u32, ne u32[n_dims],
             name bytes; (ggjt: pad to 32B boundary); raw data }.

Copy of `llamavk_tpu/formats/ggml_io.py` (pure NumPy): the port keeps its own so
that it imports nothing from the JAX package.
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .q4 import (
    GGML_FTYPE_F16,
    GGML_FTYPE_F32,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    QK,
    ftype_row_bytes,
    q4_0_from_bytes,
    q4_1_from_bytes,
)


class GGMLMagic(enum.Enum):
    GGML = 0x67676D6C  # v0: no scores, not mmap-aligned
    GGMF = 0x67676D66  # v1: scores
    GGJT = 0x67676A74  # v1: scores + 32-byte aligned tensor data (mmap-able)


@dataclass
class Hparams:
    n_vocab: int
    n_embd: int
    n_mult: int
    n_head: int
    n_layer: int
    n_rot: int
    ftype: int  # the file-level f16/quantization code

    @property
    def n_ff(self) -> int:
        # FFN hidden size derivation, llama.cpp:771
        return ((2 * 4 * self.n_embd // 3 + self.n_mult - 1) // self.n_mult) * self.n_mult

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


@dataclass
class TokenEntry:
    text: bytes
    score: float


@dataclass
class TensorShard:
    file_idx: int
    file_off: int
    ne: tuple[int, ...]  # ggml order: ne[0] = innermost/contiguous dim
    ftype: int

    @property
    def nbytes(self) -> int:
        n = int(np.prod(self.ne))
        return ftype_row_bytes(self.ftype, n)


# Multi-part split classification, llama.cpp:276-287 / llama_internal.h:37-41.
# "Columns" in ggml's ne[0]-major convention = the contiguous input dim.
SPLIT_NONE = 0
SPLIT_BY_COLUMNS = 1
SPLIT_BY_ROWS = 2


def split_type_for(name: str, n_dims: int, n_shards: int) -> int:
    if n_dims == 1 or n_shards == 1:
        return SPLIT_NONE
    if (
        name.startswith("tok_embeddings.")
        or ".attention.wo.weight" in name
        or ".feed_forward.w2.weight" in name
    ):
        return SPLIT_BY_COLUMNS
    return SPLIT_BY_ROWS


@dataclass
class TensorRecord:
    """A logical tensor, possibly assembled from shards across part-files."""

    name: str
    shards: list[TensorShard] = field(default_factory=list)

    @property
    def ftype(self) -> int:
        return self.shards[0].ftype

    @property
    def split_type(self) -> int:
        return split_type_for(self.name, len(self.shards[0].ne), len(self.shards))

    @property
    def ne(self) -> tuple[int, ...]:
        ne0 = self.shards[0].ne
        st = self.split_type
        ns = len(self.shards)
        if st == SPLIT_NONE:
            return ne0
        if st == SPLIT_BY_COLUMNS:
            return (ne0[0] * ns, ne0[1])
        return (ne0[0], ne0[1] * ns)  # SPLIT_BY_ROWS

    @property
    def shape(self) -> tuple[int, ...]:
        """NumPy (row-major) shape: reversed ggml ne."""
        return tuple(reversed(self.ne))

    @property
    def nbytes(self) -> int:
        return ftype_row_bytes(self.ftype, int(np.prod(self.ne)))


_HPARAMS_STRUCT = struct.Struct("<7I")


class _PartReader:
    def __init__(self, path: str, file_idx: int):
        self.path = path
        self.file_idx = file_idx
        self.data = np.memmap(path, dtype=np.uint8, mode="r")
        self.pos = 0

    def u32(self) -> int:
        v = int.from_bytes(self.data[self.pos : self.pos + 4], "little")
        self.pos += 4
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data[self.pos : self.pos + 4].tobytes())[0]
        self.pos += 4
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return v


class CheckpointReader:
    """Reads one model from 1..N ggml part files (mmap-backed, lazy tensors).

    Parity surface: llama_file_loader + llama_load_tensors_map
    (`llama.cpp:319-418`) incl. multi-part merge (`llama.cpp:607-652`).
    """

    def __init__(self, path: str, n_parts: int | None = None):
        self.paths = self._find_parts(path, n_parts)
        self.parts: list[_PartReader] = []
        self.tensors: dict[str, TensorRecord] = {}
        for idx, p in enumerate(self.paths):
            self._read_part(p, idx)

    @staticmethod
    def _find_parts(path: str, n_parts: int | None) -> list[str]:
        if n_parts == 1 or not os.path.exists(path + ".1"):
            return [path]
        paths = [path]
        i = 1
        while os.path.exists(f"{path}.{i}") and (n_parts is None or i < n_parts):
            paths.append(f"{path}.{i}")
            i += 1
        return paths

    def _read_part(self, path: str, file_idx: int) -> None:
        r = _PartReader(path, file_idx)
        magic = r.u32()
        if magic == GGMLMagic.GGML.value:
            version = 0
            magic_e = GGMLMagic.GGML
        else:
            version = r.u32()
            try:
                magic_e = GGMLMagic(magic)
            except ValueError:
                raise ValueError(f"unknown magic {magic:#x} in {path}")
            if version != 1:
                raise ValueError(f"unsupported version {version} for {magic_e}")
        has_scores = magic_e in (GGMLMagic.GGMF, GGMLMagic.GGJT)
        aligned = magic_e is GGMLMagic.GGJT

        hp = Hparams(*_HPARAMS_STRUCT.unpack(r.raw(_HPARAMS_STRUCT.size)))
        if file_idx == 0:
            self.magic = magic_e
            self.version = version
            self.hparams = hp
            self.vocab = self._read_vocab(r, hp.n_vocab, has_scores)
        else:
            # hparams/vocab are duplicated per part; skip vocab
            self._read_vocab(r, hp.n_vocab, has_scores)

        total = r.data.size
        while r.pos < total:
            n_dims = r.u32()
            name_len = r.u32()
            ftype = r.u32()
            ne = tuple(r.u32() for _ in range(n_dims))
            if not 1 <= n_dims <= 2:
                raise ValueError(f"tensor should be 1- or 2-D, got {n_dims}")
            if ftype not in (GGML_FTYPE_F32, GGML_FTYPE_F16, GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
                raise ValueError(f"unrecognized ftype {ftype}")
            name = r.raw(name_len).decode("utf-8")
            if aligned:
                r.pos += -r.pos & 31
            shard = TensorShard(file_idx=file_idx, file_off=r.pos, ne=ne, ftype=ftype)
            r.pos += shard.nbytes
            self.tensors.setdefault(name, TensorRecord(name)).shards.append(shard)
        self.parts.append(r)

    @staticmethod
    def _read_vocab(r: _PartReader, n_vocab: int, has_scores: bool) -> list[TokenEntry]:
        vocab = []
        for _ in range(n_vocab):
            ln = r.u32()
            text = r.raw(ln)
            score = r.f32() if has_scores else 0.0
            vocab.append(TokenEntry(text, score))
        return vocab

    # --- tensor materialization -------------------------------------------

    def _shard_bytes(self, shard: TensorShard) -> np.ndarray:
        r = self.parts[shard.file_idx]
        return r.data[shard.file_off : shard.file_off + shard.nbytes]

    def raw_tensor(self, name: str) -> np.ndarray:
        """Merged raw byte stream of a tensor (shards assembled per split type)."""
        t = self.tensors[name]
        st = t.split_type
        if st == SPLIT_NONE:
            return np.asarray(self._shard_bytes(t.shards[0]))
        if st == SPLIT_BY_ROWS:
            # shards stack along the outer (ne[1]) dim: plain concatenation
            return np.concatenate([self._shard_bytes(s) for s in t.shards])
        # SPLIT_BY_COLUMNS: interleave per-row chunks across shards
        num_rows = t.ne[1]
        bufs = [
            np.asarray(self._shard_bytes(s)).reshape(num_rows, -1) for s in t.shards
        ]
        return np.stack(bufs, axis=1).reshape(-1)

    def load_f32(self, name: str) -> np.ndarray:
        """Load and dequantize a tensor to f32 in NumPy row-major shape: f16
        and q4 through the native library where it builds (the same bytes),
        else NumPy."""
        from .. import native

        t = self.tensors[name]
        raw = self.raw_tensor(name)
        n = int(np.prod(t.ne))
        ft = t.ftype
        if ft == GGML_FTYPE_F32:
            out = raw.view(np.float32)[:n].astype(np.float32)
        elif ft == GGML_FTYPE_F16:
            out = native.fp16_to_fp32(raw.view(np.uint16)[:n])
            if out is None:
                out = raw.view(np.float16)[:n].astype(np.float32)
        elif ft == GGML_FTYPE_Q4_0:
            out = native.dequantize_stream(raw, n, ft)
            if out is None:
                d, q = q4_0_from_bytes(raw, n)
                out = ((q.astype(np.float32) - 8.0) * d[:, None]).reshape(-1)
        elif ft == GGML_FTYPE_Q4_1:
            out = native.dequantize_stream(raw, n, ft)
            if out is None:
                d, m, q = q4_1_from_bytes(raw, n)
                out = (q.astype(np.float32) * d[:, None] + m[:, None]).reshape(-1)
        else:
            raise ValueError(f"ftype {ft}")
        return out.reshape(t.shape)

    def load_q4(self, name: str):
        """Load a q4 tensor's block data without dequantizing.

        Returns (d [rows, nb], q [rows, nb, QK]) for Q4_0 or
        (d, m, q) for Q4_1, where rows = shape[0] (output channels).
        """
        t = self.tensors[name]
        raw = self.raw_tensor(name)
        n = int(np.prod(t.ne))
        rows = t.shape[0] if len(t.shape) == 2 else 1
        row_n = n // rows
        if t.ftype == GGML_FTYPE_Q4_0:
            d, q = q4_0_from_bytes(raw, n)
            return d.reshape(rows, row_n // QK), q.reshape(rows, row_n // QK, QK)
        if t.ftype == GGML_FTYPE_Q4_1:
            d, m, q = q4_1_from_bytes(raw, n)
            return (
                d.reshape(rows, row_n // QK),
                m.reshape(rows, row_n // QK),
                q.reshape(rows, row_n // QK, QK),
            )
        raise ValueError(f"tensor {name} is not q4 (ftype {t.ftype})")


class CheckpointWriter:
    """Writes a single-part GGJT v1 file (the reference's llama_file_saver)."""

    def __init__(self, path: str, hparams: Hparams, vocab: list[TokenEntry]):
        self.f = open(path, "wb")
        self.f.write(struct.pack("<II", GGMLMagic.GGJT.value, 1))
        self.f.write(
            _HPARAMS_STRUCT.pack(
                hparams.n_vocab,
                hparams.n_embd,
                hparams.n_mult,
                hparams.n_head,
                hparams.n_layer,
                hparams.n_rot,
                hparams.ftype,
            )
        )
        for tok in vocab:
            self.f.write(struct.pack("<I", len(tok.text)))
            self.f.write(tok.text)
            self.f.write(struct.pack("<f", tok.score))

    def write_tensor(self, name: str, ne: tuple[int, ...], ftype: int, data: bytes) -> None:
        nm = name.encode("utf-8")
        self.f.write(struct.pack("<III", len(ne), len(nm), ftype))
        for d in ne:
            self.f.write(struct.pack("<I", d))
        self.f.write(nm)
        pad = -self.f.tell() & 31
        self.f.write(b"\x00" * pad)
        assert len(data) == ftype_row_bytes(ftype, int(np.prod(ne)))
        self.f.write(data)

    def write_array(self, name: str, arr: np.ndarray, ftype: int | None = None) -> None:
        """Write a NumPy f32/f16 array (row-major; ne = reversed shape)."""
        if ftype is None:
            ftype = GGML_FTYPE_F16 if arr.dtype == np.float16 else GGML_FTYPE_F32
        dt = np.float16 if ftype == GGML_FTYPE_F16 else np.float32
        ne = tuple(reversed(arr.shape))
        self.write_tensor(name, ne, ftype, np.ascontiguousarray(arr, dtype=dt).tobytes())

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

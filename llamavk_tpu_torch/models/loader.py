"""Checkpoint → device params (twin of `llamavk_tpu/models/loader.py`).

Reads GGML/GGMF/GGJT tensors, repacks quantized weights into the device
layout (ilv, or lin with `layout="lin"`) with the native single-pass repack
of `native.py`, or the NumPy repack of `formats/repack.py` where the native
library is not available or LLAMAVK_NO_NATIVE is set (the two give the same
bytes), stacks the per-layer weights and moves everything to the device
once. Also builds synthetic 7B params on the device and carries parameters
across from the JAX package (`params_from_arrays`).

Tensor-parallel packing (`tp` > 1, loader.py:55-95, :191 there): the
row-parallel kinds `wo` and `w2` are packed as `tp` independent K chunks,
so that a tp shard of their K axis is whole chunks (`parallel/sharding.py`),
and the fused `wqkv`/`w13` interleave per-shard column segments, so that
tp shard i of the fused N axis is [q_i | k_i | v_i] (gate_i | up_i). Such
params are the same model as tp = 1 params: `regroup_fused` takes their
fused columns back to another tp's order, and chunked `wo`/`w2` multiply as
they are (one K1 launch per chunk).
"""

from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..formats.ggml_io import CheckpointReader, CheckpointWriter, Hparams, TokenEntry
from ..formats.q4 import (
    GGML_FTYPE_F16,
    GGML_FTYPE_F32,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    QK,
    q4_0_to_bytes,
    quantize_q4_0,
)
from ..formats.repack import (
    LAYOUT_ILV,
    LAYOUT_LIN,
    PackedQ4,
    _interleave_cols,
    fuse_packed,
    repack_q4_0,
    repack_q4_1,
)
from ..ops.qweight import QWeight
from ..tokenizer import Tokenizer
from .llama import FusedLayerParams, LayerParams, LlamaParams, ModelConfig, QEmbedding

LLAMA_CONFIGS = {
    # n_layer-keyed family table, llama.cpp:773-779 + n_ff derivation
    "7B": dict(n_vocab=32000, n_embd=4096, n_layer=32, n_head=32, n_rot=128, n_ff=11008),
    "13B": dict(n_vocab=32000, n_embd=5120, n_layer=40, n_head=40, n_rot=128, n_ff=13824),
    "30B": dict(n_vocab=32000, n_embd=6656, n_layer=60, n_head=52, n_rot=128, n_ff=17920),
    "65B": dict(n_vocab=32000, n_embd=8192, n_layer=80, n_head=64, n_rot=128, n_ff=22016),
}


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """NumPy → torch on `device`. bf16 arrays (ml_dtypes, as the JAX package
    hands them out) travel as their 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


# the row-parallel kinds: their K axis splits over tp, so they are packed in
# tp chunks (ROW_PARALLEL_KINDS of loader.py there)
ROW_PARALLEL_KINDS = ("wo", "w2")


def _read_packed(reader: CheckpointReader, name: str, layout: str, chunks: int = 1):
    """A 2-D matmul weight as PackedQ4 (q4, its K axis packed in `chunks`
    independent slices) or dense f32 [K, N]: the native repack straight off
    the mapped file where it is built, else NumPy."""
    t = reader.tensors[name]
    if t.ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        pk = native.repack_q4_stream(reader.raw_tensor(name), t.shape[0], t.ne[0], t.ftype,
                                     layout, chunks)
        if pk is not None:
            return pk
    if t.ftype == GGML_FTYPE_Q4_0:
        d, q = reader.load_q4(name)
        return repack_q4_0(d, q, layout=layout, chunks=chunks)
    if t.ftype == GGML_FTYPE_Q4_1:
        d, m, q = reader.load_q4(name)
        return repack_q4_1(d, m, q, layout=layout, chunks=chunks)
    return np.ascontiguousarray(reader.load_f32(name).T)  # dense [K, N]


def _fuse(parts, tp: int = 1):
    """Fuse column-parallel parts along N, per-tp-shard segments interleaved
    (loader.py:91-95 there)."""
    if all(isinstance(p, PackedQ4) for p in parts):
        return fuse_packed(parts, tp)
    if all(isinstance(p, np.ndarray) for p in parts):
        return _interleave_cols(parts, tp)
    return None  # mixed q4/dense: caller falls back to unfused


def _stack_to_device(parts: list, scale_dtype, dense_dtype, device):
    """Per-layer PackedQ4s (or dense arrays) → one stacked QWeight (tensor)."""
    p0 = parts[0]
    if isinstance(p0, PackedQ4):
        return QWeight(
            packed=_tensor(np.stack([p.packed for p in parts]), device),
            scales=_tensor(np.stack([p.scales for p in parts]), device, scale_dtype),
            bias=None if p0.bias is None
            else _tensor(np.stack([p.bias for p in parts]), device, scale_dtype),
            layout=p0.layout,
            chunks=p0.chunks,
        )
    return _tensor(np.stack(parts), device, dense_dtype)


def _one_to_device(p, scale_dtype, dense_dtype, device):
    if isinstance(p, PackedQ4):
        return QWeight(
            packed=_tensor(p.packed, device),
            scales=_tensor(p.scales, device, scale_dtype),
            bias=None if p.bias is None else _tensor(p.bias, device, scale_dtype),
            layout=p.layout,
            chunks=p.chunks,
        )
    return _tensor(p, device, dense_dtype)


def _pack_embedding_rows(qs_signed: np.ndarray) -> np.ndarray:
    """[V, K] signed nibbles → [V, K//2] split-half packed bytes (linear)."""
    k = qs_signed.shape[1]
    lo = qs_signed[:, : k // 2]
    hi = qs_signed[:, k // 2 :]
    return ((lo & 0xF) | (hi << 4)).astype(np.int8)


def _load_embedding(reader: CheckpointReader, name: str, scale_dtype, dense_dtype, device):
    t = reader.tensors[name]
    if t.ftype in (GGML_FTYPE_F16, GGML_FTYPE_F32):
        return _tensor(reader.load_f32(name), device, dense_dtype)
    packed_sb = native.repack_q4_rows_stream(reader.raw_tensor(name), t.shape[0], t.ne[0],
                                             t.ftype)
    if packed_sb is not None:
        packed, scales, bias = packed_sb
        return QEmbedding(
            packed=_tensor(packed, device),
            scales=_tensor(scales, device, scale_dtype),
            bias=None if bias is None else _tensor(bias, device, scale_dtype),
            k=t.ne[0],
        )
    if t.ftype == GGML_FTYPE_Q4_0:
        d, q = reader.load_q4(name)  # [V, G], [V, G, QK]
        bias = None
    else:
        d, m, q = reader.load_q4(name)
        bias = m + 8.0 * d
    v, g, _ = q.shape
    qs = (q.astype(np.int16) - 8).astype(np.int8).reshape(v, g * QK)
    return QEmbedding(
        packed=_tensor(_pack_embedding_rows(qs), device),
        scales=_tensor(np.asarray(d, np.float32), device, scale_dtype),
        bias=None if bias is None else _tensor(np.asarray(bias, np.float32), device, scale_dtype),
        k=g * QK,
    )


def params_from_reader(
    reader: CheckpointReader,
    layout: str = LAYOUT_ILV,
    scale_dtype=torch.bfloat16,
    dense_dtype=torch.bfloat16,
    fuse: bool = True,
    device="cuda",
    progress_callback=None,
    tp: int = 1,
) -> tuple[ModelConfig, LlamaParams]:
    """Build the device params. `fuse` concatenates wq|wk|wv and w1|w3 (two
    launches fewer per layer). `progress_callback(frac)` runs per layer.
    Q4_0, Q4_1, f16 and f32 tensors. `tp` > 1 packs for tensor
    parallelism: `wo`/`w2` in tp K chunks and the fused weights' columns
    interleaved per shard (module docstring); the params stay whole, and
    `parallel.sharding.shard_params` cuts a rank's shard from them."""
    device = resolve(device)
    cfg = ModelConfig.from_hparams(reader.hparams)
    # trust the tensors over the n_mult-derived n_ff
    w1 = reader.tensors.get("layers.0.feed_forward.w1.weight")
    if w1 is not None and w1.ne[1] != cfg.n_ff:
        cfg = replace(cfg, n_ff=int(w1.ne[1]))
    total_bytes = sum(t.nbytes for t in reader.tensors.values())
    print(
        f"llamavk: model {cfg.type_name}: n_vocab={cfg.n_vocab} n_embd={cfg.n_embd}"
        f" n_layer={cfg.n_layer} n_head={cfg.n_head} n_ff={cfg.n_ff};"
        f" checkpoint {total_bytes / 1e9:.2f} GB",
        file=sys.stderr,
    )

    def rp(name, kind=""):
        return _read_packed(reader, name, layout, tp if kind in ROW_PARALLEL_KINDS else 1)

    names = {
        "wq": "attention.wq.weight", "wk": "attention.wk.weight",
        "wv": "attention.wv.weight", "wo": "attention.wo.weight",
        "w1": "feed_forward.w1.weight", "w2": "feed_forward.w2.weight",
        "w3": "feed_forward.w3.weight",
    }
    per_layer: dict[str, list] = {}
    fused = fuse
    for i in range(cfg.n_layer):
        if progress_callback is not None:
            progress_callback(i / cfg.n_layer)
        p = f"layers.{i}."
        w = {kind: rp(p + nm, kind) for kind, nm in names.items()}
        w["attn_norm"] = reader.load_f32(p + "attention_norm.weight")
        w["ffn_norm"] = reader.load_f32(p + "ffn_norm.weight")
        if fused:
            wqkv = _fuse([w["wq"], w["wk"], w["wv"]], tp)
            w13 = _fuse([w["w1"], w["w3"]], tp)
            if wqkv is None or w13 is None:
                fused = False
                if i:
                    raise ValueError("params_from_reader: mixed q4/dense layers cannot fuse")
            else:
                w = {"attn_norm": w["attn_norm"], "wqkv": wqkv, "wo": w["wo"],
                     "ffn_norm": w["ffn_norm"], "w13": w13, "w2": w["w2"]}
        for kind, val in w.items():
            per_layer.setdefault(kind, []).append(val)

    def stacked(kind):
        parts = per_layer[kind]
        if kind.endswith("norm"):
            return _tensor(np.stack(parts), device, torch.float32)
        return _stack_to_device(parts, scale_dtype, dense_dtype, device)

    cls = FusedLayerParams if fused else LayerParams
    layers = cls(**{kind: stacked(kind) for kind in per_layer})
    params = LlamaParams(
        tok_embeddings=_load_embedding(
            reader, "tok_embeddings.weight", scale_dtype, dense_dtype, device
        ),
        layers=layers,
        norm=_tensor(reader.load_f32("norm.weight"), device, torch.float32),
        output=_one_to_device(rp("output.weight"), scale_dtype, dense_dtype, device),
    )
    return cfg, params


def load_model(
    path: str, n_parts: int | None = None, device="cuda", **kw
) -> tuple[ModelConfig, LlamaParams, Tokenizer]:
    resolve(device)
    reader = CheckpointReader(path, n_parts)
    cfg, params = params_from_reader(reader, device=device, **kw)
    return cfg, params, Tokenizer(reader.vocab)


def params_from_arrays(
    arrays: dict[str, np.ndarray], cfg: ModelConfig, device="cuda", layout: str = LAYOUT_ILV,
    tp: int = 1,
) -> LlamaParams:
    """Carry parameters across from the JAX package: `arrays` holds its
    LlamaParams flattened to NumPy, keyed by attribute path
    (`layers.wqkv.packed`, `tok_embeddings.scales`, `norm`, ...). Packed
    weights keep their bytes, layout and dtypes. The JAX package's static
    fields are not leaves: `layout` names the packed layout (ilv by default,
    as its loader writes), and `tp` the packing of params its loader made
    with `tp=` (`wo`/`w2` in tp chunks, fused columns interleaved), which
    they keep."""
    device = resolve(device)

    def t(key):
        return _tensor(arrays[key], device)

    def weight(prefix):
        if prefix + ".packed" in arrays:
            kind = prefix.split(".")[-1]
            return QWeight(
                packed=t(prefix + ".packed"),
                scales=t(prefix + ".scales"),
                bias=t(prefix + ".bias") if prefix + ".bias" in arrays else None,
                layout=layout,
                chunks=tp if kind in ROW_PARALLEL_KINDS else 1,
            )
        return t(prefix)

    if "tok_embeddings.packed" in arrays:
        emb = QEmbedding(
            packed=t("tok_embeddings.packed"),
            scales=t("tok_embeddings.scales"),
            bias=t("tok_embeddings.bias") if "tok_embeddings.bias" in arrays else None,
            k=cfg.n_embd,
        )
    else:
        emb = t("tok_embeddings")
    fused = any(k.startswith("layers.wqkv") for k in arrays)
    kinds = ("wqkv", "wo", "w13", "w2") if fused else ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
    cls = FusedLayerParams if fused else LayerParams
    layers = cls(
        attn_norm=t("layers.attn_norm"),
        ffn_norm=t("layers.ffn_norm"),
        **{kind: weight("layers." + kind) for kind in kinds},
    )
    return LlamaParams(tok_embeddings=emb, layers=layers, norm=t("norm"), output=weight("output"))


def synthetic_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                     scale_dtype=torch.bfloat16, layout: str = LAYOUT_ILV,
                     tp: int = 1) -> LlamaParams:
    """Random Q4_0-packed fused params made on the device from one seeded
    generator: packed bytes uniform in [-128, 128), scales uniform in
    [0.005, 0.02] then bf16, norms 1 — the distributions of the JAX
    package's synthetic_params (loader.py:509-543). `layout` names the
    weight planes' layout, ilv or lin; random bytes are a valid plane of
    either, so the same seed gives the same bytes. `tp` > 1 marks `wo`/`w2`
    as packed in tp chunks and the fused columns as interleaved per shard
    (the tp packing of `params_from_reader`): the same bytes, read as that
    packing. For running the compute path at full width without real
    weights."""
    if layout not in (LAYOUT_ILV, LAYOUT_LIN):
        raise NotImplementedError(f"synthetic_params: layout {layout!r} (ilv or lin)")
    device = resolve(device)
    g = torch.Generator(device=device).manual_seed(seed)
    L, e, f, v = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab

    def packed(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=device, generator=g)

    def scales(*shape):
        s = torch.empty(shape, dtype=torch.float32, device=device)
        return s.uniform_(0.005, 0.02, generator=g).to(scale_dtype)

    def qw(k, n, lead=(), chunks=1):
        return QWeight(packed=packed(*lead, k // 2, n), scales=scales(*lead, k // QK, n),
                       layout=layout, chunks=chunks)

    norm_l = torch.ones((L, e), dtype=torch.float32, device=device)
    layers = FusedLayerParams(
        attn_norm=norm_l,
        wqkv=qw(e, 3 * e, (L,)),
        wo=qw(e, e, (L,), tp),
        ffn_norm=norm_l.clone(),
        w13=qw(e, 2 * f, (L,)),
        w2=qw(f, e, (L,), tp),
    )
    emb = QEmbedding(packed=packed(v, e // 2), scales=scales(v, e // QK), bias=None, k=e)
    return LlamaParams(
        tok_embeddings=emb,
        layers=layers,
        norm=torch.ones((e,), dtype=torch.float32, device=device),
        output=qw(e, v),
    )


def regroup_fused(params: LlamaParams, tp: int, to_tp: int = 1) -> LlamaParams:
    """The same params with the fused `wqkv`/`w13` columns moved from tp's
    per-shard interleave (`fuse_packed(parts, tp)`) to to_tp's; `wo`/`w2`
    and every other tensor are kept (shared, not copied). A column
    permutation of the packed, scale and bias planes: exact. to_tp = 1
    gives the order a single device reads ([q | k | v], [gate | up]), with
    `wo`/`w2` still in their tp chunks."""
    lp = params.layers
    if not isinstance(lp, FusedLayerParams) or tp == to_tp:
        return params

    def perm(n: int, parts: int, a: int, b: int) -> torch.Tensor:
        # interleave a -> interleave b: column (part j, shard s of a, offset c)
        cols = torch.arange(n).reshape(a, parts, n // (a * parts))
        seg = cols.permute(1, 0, 2).reshape(parts, n // parts)  # each part's columns
        return seg.reshape(parts, b, -1).permute(1, 0, 2).reshape(-1)

    def regroup(w, parts: int):
        idx = perm(w.n if isinstance(w, QWeight) else w.shape[-1], parts, tp, to_tp)
        if isinstance(w, QWeight):
            idx = idx.to(w.packed.device)
            return replace(w, packed=w.packed[..., idx].contiguous(),
                           scales=w.scales[..., idx].contiguous(),
                           bias=None if w.bias is None else w.bias[..., idx].contiguous())
        return w[..., idx.to(w.device)].contiguous()

    layers = replace(lp, wqkv=regroup(lp.wqkv, 3), w13=regroup(lp.w13, 2))
    return replace(params, layers=layers)


def random_tiny_model(
    n_vocab=256,
    n_embd=128,
    n_layer=2,
    n_head=2,
    n_ff=256,
    n_mult=32,
    seed=0,
    write_path: str | None = None,
    quantize: bool = True,
):
    """A tiny random LLaMA checkpoint (NumPy copy of the JAX package's
    random_tiny_model: same seed, same tensors, same file).

    If write_path is given, writes a real GGJT file; returns (hparams, tensors)
    where tensors maps name → f32 numpy array (pre-quantization values)."""
    rng = np.random.default_rng(seed)
    hp = Hparams(
        n_vocab=n_vocab,
        n_embd=n_embd,
        n_mult=n_mult,
        n_head=n_head,
        n_layer=n_layer,
        n_rot=n_embd // n_head,
        ftype=GGML_FTYPE_Q4_0 if quantize else GGML_FTYPE_F32,
    )

    def w(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tensors: dict[str, np.ndarray] = {
        "tok_embeddings.weight": w(n_vocab, n_embd),
        "norm.weight": np.abs(w(n_embd)) + 0.5,
        "output.weight": w(n_vocab, n_embd),
    }
    for i in range(n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = np.abs(w(n_embd)) + 0.5
        tensors[p + "ffn_norm.weight"] = np.abs(w(n_embd)) + 0.5
        for nm, shape in [
            ("attention.wq.weight", (n_embd, n_embd)),
            ("attention.wk.weight", (n_embd, n_embd)),
            ("attention.wv.weight", (n_embd, n_embd)),
            ("attention.wo.weight", (n_embd, n_embd)),
            ("feed_forward.w1.weight", (n_ff, n_embd)),
            ("feed_forward.w2.weight", (n_embd, n_ff)),
            ("feed_forward.w3.weight", (n_ff, n_embd)),
        ]:
            tensors[p + nm] = w(*shape)

    if write_path is not None:
        vocab = [TokenEntry(f"<t{i}>".encode(), -float(i)) for i in range(n_vocab)]
        with CheckpointWriter(write_path, hp, vocab) as wtr:
            for name, arr in tensors.items():
                if quantize and arr.ndim == 2 and name.endswith("weight") and "norm" not in name:
                    d, q = quantize_q4_0(arr)
                    wtr.write_tensor(
                        name,
                        tuple(reversed(arr.shape)),
                        GGML_FTYPE_Q4_0,
                        q4_0_to_bytes(d, q),
                    )
                else:
                    wtr.write_array(name, arr, GGML_FTYPE_F32)
    return hp, tensors

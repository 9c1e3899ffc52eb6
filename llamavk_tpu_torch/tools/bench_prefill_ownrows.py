"""P5 on Hopper: does prefill attention need K2's read-modify-write
discipline, and its two launches?

The port of `tools/bench_prefill_ownrows.py` (its kernel `kern_direct` :39).
At n_past 0 every key a query sees is a row of this call's own input, so
one launch can write the rows into the cache and attend over them without
reading the cache back: `csrc/probe_prefill_direct.cu`. GPU blocks run in no
order, so no block reads rows another block writes: every key comes from
the input and the cache is only written (the TPU kernel, whose t blocks run
in order, read earlier blocks' rows back from the cache).

    python -m llamavk_tpu_torch.tools.bench_prefill_ownrows          # the card
    python -m llamavk_tpu_torch.tools.bench_prefill_ownrows --device cpu

At b 1, T 512, h 32, d 128, cache S 512 (7B's layer; the CPU: T 64, h 4,
d 32, S 64) and each KV block of the TPU probe's list, one line each on
stderr: the kernel's time, its error against the plain version (err/limit)
and, as the TPU probe prints it, against the dense oracle
`ops.flash_attn.attention_ref`, and whether the cache rows are the input's
bit for bit; then K2
(`ops.flash_attn.flash_attention_update`, its write and attention launches)
and `scaled_dot_product_attention` on the same inputs.
"""

from __future__ import annotations

import math

import torch

from ..ops import _build
from ..ops.flash_attn import attend_ref, attention_ref, flash_attention_update, visible_mask
from . import _common

launches = {"direct": 0}
_SIGS = (("prefill_direct_launch", "ppppppiiiiiifp"),)
# KV blocks of the TPU probe's (hg, bt, bk) list: 256 and 512 (the card's
# kernel takes one query row a warp, so hg and bt have no counterpart)
BLOCKS = (256, 512)


def prefill_direct_ref(q, k_new, v_new, k_cache, v_cache) -> torch.Tensor:
    """Plain version of `prefill_direct`: the rows written into the cache
    (in place), then the causal attention of `ops.flash_attn.attend_ref`
    (its rounding points) over the input's rows. q, k_new, v_new [B, H, T,
    D]; returns f32 [B, H, T, D]."""
    b, h, t, d = q.shape
    k_cache[0, :, :, :t] = k_new
    v_cache[0, :, :, :t] = v_new
    vis = visible_mask(0, b, t, t, q.device)
    return attend_ref(q.transpose(1, 2), k_new, v_new, vis).transpose(1, 2)


def prefill_direct(q, k_new, v_new, k_cache, v_cache, block_k: int = 256) -> torch.Tensor:
    """Causal prefill attention at n_past 0 in one launch: q, k_new, v_new
    bf16 [B, H, T, D], the cache k, v bf16 [1, B, H, S, D] (T <= S), whose
    rows [0, T) are written in place; returns f32 [B, H, T, D]. CUDA tensors
    launch the kernel (D 64 or 128), CPU tensors take `prefill_direct_ref`."""
    if not q.is_cuda:
        return prefill_direct_ref(q, k_new, v_new, k_cache, v_cache)
    b, h, t, d = q.shape
    s = k_cache.shape[3]
    if (k_new.shape != q.shape or v_new.shape != q.shape or k_cache.shape != (1, b, h, s, d)
            or v_cache.shape != k_cache.shape or t > s or d not in (64, 128)
            or block_k % 8 or any(a.dtype != torch.bfloat16
                                  for a in (q, k_new, v_new, k_cache, v_cache))):
        raise ValueError(f"probe prefill_direct: q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} (bf16, D 64 or 128, T <= S)")
    _common.require_cuda("probe prefill_direct", q, k_new, v_new, k_cache, v_cache)
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    rc = _common.lib("probe_prefill_direct", _SIGS).prefill_direct_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), b, h, t, s, d, block_k, 1.0 / math.sqrt(d), _common.stream(q))
    _build.check(rc, "prefill_direct_launch")
    launches["direct"] += 1
    return out


def _case(gen, b, t, h, s, d, device):
    q, kn, vn = (torch.randn((b, h, t, d), device=device, generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    kc, vc = (torch.randn((1, b, h, s, d), device=device, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    return q, kn, vn, kc, vc


def run(device, reps: int = 20) -> list[dict]:
    """The kernel at each KV block against its plain version: within 2^-6
    attention(q, k, |v|) per element (each side rounds the probabilities to
    bf16, relative to another max where the kernel's walk rescales), the
    cache rows [0, T) the input's bit for bit, and the rows past a call
    unchanged (a call of 3T/4 rows first); with K2's and SDPA's times."""
    cuda = device.type == "cuda"
    b, t, h, s, d = (1, 512, 32, 512, 128) if cuda else (1, 64, 4, 64, 32)
    timer = _common.Timer(reps) if cuda else None
    gen = torch.Generator(device=device).manual_seed(0)
    q, kn, vn, kc, vc = _case(gen, b, t, h, s, d, device)
    # a shorter call over the same cache: the rows past it stay as they were
    tp = 3 * t // 4
    before = kc.clone()
    prefill_direct(q[:, :, :tp].contiguous(), kn[:, :, :tp].contiguous(),
                   vn[:, :, :tp].contiguous(), kc, vc)
    rest_kept = torch.equal(kc[:, :, :, tp:], before[:, :, :, tp:])
    limit = 2.0**-6 * prefill_direct_ref(q, kn, vn.abs(), kc.clone(), vc.clone())
    n_bytes = 3 * b * h * t * d * 2 + b * h * t * d * 4 + 2 * b * h * t * d * 2
    n_ops = 2 * 2.0 * b * h * d * t * (t + 1) / 2
    rows = []
    if cuda:  # K2 (write, then attend: two launches) and SDPA on the same inputs
        qt, knt, vnt = (a.transpose(1, 2).contiguous() for a in (q, kn, vn))
        k2c, v2c = kc.clone(), vc.clone()
        k2 = timer(lambda: flash_attention_update(qt, knt, vnt, k2c, v2c, 0, 0, block_t=256,
                                                  block_k=256))
        sdpa = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kn, vn, is_causal=True))
    for bk in BLOCKS if cuda else (32,):
        kc.copy_(before)
        prefill_direct(q, kn, vn, kc, vc, bk)
        rows_equal = torch.equal(kc[0, :, :, :t], kn) and torch.equal(vc[0, :, :, :t], vn)
        oracle = float((prefill_direct(q, kn, vn, kc, vc, bk) - attention_ref(
            q.transpose(1, 2), kn, vn, 0).transpose(1, 2)).abs().max())
        row = _common.measure(
            "probe_p5_direct", f"direct bk={bk}", f"b={b} T={t} h={h} d={d} S={s} bk={bk}",
            lambda bk=bk: prefill_direct(q, kn, vn, kc, vc, bk),
            lambda: prefill_direct_ref(q, kn, vn, kc.clone(), vc.clone()),
            timer=timer, n_bytes=n_bytes, n_ops=n_ops, limit=limit,
            checks={"cache_rows_exact": rows_equal, "other_rows_unchanged": rest_kept})
        row["err_vs_attention_ref"] = oracle
        if cuda:
            row["production_ms"], row["library_ms"], row["library"] = k2, sdpa, "sdpa"
            _common.log(f"direct bk={bk}: {row['ms']:6.3f} ms/layer (x32 = "
                        f"{row['ms'] * 32:5.1f} ms/chunk)  err/limit {row['err_over_limit']:.3f} "
                        f"err {oracle:.4f} cache-exact {rows_equal}")
        else:
            _common.log(f"direct bk={bk}: {'ok' if row['ok'] else 'MISMATCH'} "
                        f"err {oracle:.4f} cache-exact {rows_equal}")
        rows.append(row)
    if cuda:
        _common.log(f"production K2 bt=256 bk=256: {k2:6.3f} ms/layer (x32 = {k2 * 32:5.1f} "
                    f"ms/chunk)  sdpa {sdpa:6.3f} ms/layer")
    return rows


def main(argv=None) -> list[dict]:
    args = _common.parser(__doc__).parse_args(argv)
    return run(_common.device_of(args), args.reps)


if __name__ == "__main__":
    main()

"""The Hopper probes: each TPU probe of `tools/` (P1-P5) asked again of the
card, with a hand-written kernel per probe kernel and its plain version
beside it. Run one as `python -m llamavk_tpu_torch.tools.<name>`; every
module takes `--device cpu` for its plain versions at small shapes.

  bench_unpack_trick      P1  magic-number bf16 unpack vs the shift unpack
  bench_int8_mxu          P2  per-block int8 tensor-core group dot
  bench_unpack2           P3  unpack variants, int4 planes, the bitcast view
  bench_i4_stacked        P4  stacked weights, the layer read on the device
  bench_prefill_ownrows   P5  one-launch prefill attention

`KERNELS` names each probe kernel with its source and the TPU kernel it
replaces; `launch_counts` and `reset_counts` read and clear their launch
counters.
"""

from __future__ import annotations

_UNPACK = "llamavk_tpu_torch/csrc/probe_q4_unpack.cu"
_I8 = "llamavk_tpu_torch/csrc/probe_q4_i8.cu"

# kernel name -> (source, the TPU kernel it replaces: file:line)
KERNELS = {
    "probe_p1_current": (_UNPACK, "tools/bench_unpack_trick.py:33"),
    "probe_p1_trick": (_UNPACK, "tools/bench_unpack_trick.py:52"),
    "probe_p2_i8": (_I8, "tools/bench_int8_mxu.py:66"),
    "probe_p2_bf16": (_I8, "tools/bench_int8_mxu.py:66"),
    "probe_p3_cur": (_UNPACK, "tools/bench_unpack2.py:45"),
    "probe_p3_i8shift": (_UNPACK, "tools/bench_unpack2.py:63"),
    "probe_p3_i8shift16": (_UNPACK, "tools/bench_unpack2.py:63"),
    "probe_p3_int4": (_UNPACK, "tools/bench_unpack2.py:83"),
    "probe_p3_int4f32": (_UNPACK, "tools/bench_unpack2.py:83"),
    "probe_p3_bitcast4": (_UNPACK, "tools/bench_unpack2.py:100"),
    "probe_p3_bitcast4f32": (_UNPACK, "tools/bench_unpack2.py:100"),
    "probe_p3_perm": (_UNPACK, "tools/bench_unpack2.py:144"),
    "probe_p3_i8dot2d": (_I8, "tools/bench_unpack2.py:171"),
    "probe_p4_prod": (_UNPACK, "tools/bench_i4_stacked.py:43"),
    "probe_p4_i4st": (_UNPACK, "tools/bench_i4_stacked.py:71"),
    "probe_p4_i4st_bf16": (_UNPACK, "tools/bench_i4_stacked.py:71"),
    "probe_p5_direct": ("llamavk_tpu_torch/csrc/probe_prefill_direct.cu",
                        "tools/bench_prefill_ownrows.py:39"),
}


def _counters() -> dict[str, tuple[dict, str]]:
    """kernel name -> (the counter dict, its key)."""
    from . import _unpack, bench_int8_mxu, bench_prefill_ownrows, bench_unpack2

    out = {f"probe_{key}": (_unpack.launches, key) for key in _unpack.launches}
    out.update({f"probe_p2_{key}": (bench_int8_mxu.launches, key)
                for key in bench_int8_mxu.launches})
    out["probe_p3_i8dot2d"] = (bench_unpack2.launches, "i8dot2d")
    out["probe_p5_direct"] = (bench_prefill_ownrows.launches, "direct")
    return out


def launch_counts() -> dict[str, int]:
    """Launches of every probe kernel since the last `reset_counts`."""
    return {name: d[key] for name, (d, key) in _counters().items()}


def reset_counts() -> None:
    for d, key in _counters().values():
        d[key] = 0

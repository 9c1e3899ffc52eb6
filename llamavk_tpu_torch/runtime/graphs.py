"""CUDA graphs of the decode steps: the port's counterpart of the JAX
package's jitted decode blocks (`make_decode_block`, engine.py:93-125 there,
and the batched blocks of batching.py:331-410), one compiled device program
a block there.

A decode step here is a function over static buffers: one forward and one
sample that read the current token, the position and the repeat window from
device tensors and advance them in place (`runtime/engine.py`,
`runtime/batching.py`). `StepGraph` captures such a step once and replays
it, one replay a token, so a block of n tokens is n replays and the host
issues n graph launches where it issued every kernel of every step. On the
CPU the engines run the same step uncaptured.

A capture calls every kernel wrapper once, and each wrapper counts a launch
there (`launches`, `shapes`, and the C side's `cuda_launches()`), though the
capture runs nothing. `LaunchTally` keeps the counters' change over the
capture, takes it back, and adds it once per replay, so the counters go on
meaning kernels launched on the device.

Sampling draws from `torch.Generator`s registered with the graph
(`CUDAGraph.register_generator_state`): a replay reads the generator's seed
and offset at its launch and advances the offset by the step's draws, so a
replayed step draws what the same step run uncaptured draws, and
`manual_seed` on the generator (in place) reseeds the replays too.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch

from ..ops import _build


def _wrapper_counters() -> list:
    """Every kernel wrapper's launch counters, in a fixed order."""
    from ..ops import flash_attn as fa
    from ..ops import flash_decode as fd
    from ..ops import q4_matmul as q4

    return [q4.launches, q4.shapes, q4.shapes_f32, q4.shapes_i8, q4.shapes_modes, fa.launches,
            fa.shapes, fd.launches, fd.shapes]


def _library_counts() -> dict[str, int]:
    """The C-side counters (`cuda_launches()`) of the kernel libraries this
    process has loaded."""
    from ..ops import flash_attn as fa
    from ..ops import flash_decode as fd
    from ..ops import q4_matmul as q4

    fns = {"q4_matmul": q4.cuda_launches, "flash_attn": fa.cuda_launches,
           "flash_decode": fd.cuda_launches}
    return {name: fn() for name, fn in fns.items() if name in _build._libs}


def launch_counts() -> list[dict]:
    """A snapshot of every launch counter: each wrapper counter's entries,
    then the loaded libraries' C-side counts."""
    return [dict(c) for c in _wrapper_counters()] + [_library_counts()]


class LaunchTally:
    """The launch counters' change between two snapshots (`launch_counts`),
    to add again `times` times: the wrapper counters by entry, the C-side
    counts through `_build.replayed`."""

    def __init__(self, before: list[dict], after: list[dict]):
        self.delta = [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
                      for b, a in zip(before, after)]

    def add(self, times: int = 1) -> None:
        for counter, d in zip(_wrapper_counters(), self.delta):
            for key, n in d.items():
                counter[key] += n * times
                if isinstance(counter, collections.Counter) and not counter[key]:
                    del counter[key]  # a shape no launch reached
        for name, n in self.delta[-1].items():
            _build.replayed[name] += n * times


class StepGraph:
    """One decode step captured in a CUDA graph on `device`. `step(gens)`
    runs the step drawing only from the generators in `gens`; `state` holds
    the buffers it advances. The step runs once uncaptured first, on scratch
    generators, and `state` is put back: that run makes the lazily grown
    per-device state a capture must not make
    (`_build.refuse_while_capturing`), and the cache rows it writes are the
    ones the first replay rewrites with the same bits (or rows no live slot
    reads). Then `step(generators)` runs once inside the capture, on the
    current thread, the generators registered with the graph. A failed
    capture raises. `capture_s` and `pool_bytes` (the memory the graph's
    private pool reserved) describe the capture."""

    def __init__(self, step: Callable[[list], None], state: list[torch.Tensor], generators: list,
                 device: torch.device):
        saved = [t.clone() for t in state]
        step([torch.Generator(device=device) for _ in generators])
        for t, v in zip(state, saved):
            t.copy_(v)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as the capture does first: the pool is what it adds
        reserved = torch.cuda.memory_reserved(device)
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.device(device), \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            step(generators)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.tally = LaunchTally(before, launch_counts())
        self.tally.add(-1)  # the capture launched nothing
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.tally.add()
        self.replays += 1

"""The device mesh (twin of `llamavk_tpu/parallel/mesh.py`), over
`torch.distributed`.

The world's ranks are laid out as a dp x pp x tp grid, tp innermost, as the
JAX mesh reshapes its devices (dp, pp, tp):

  dp — data parallel over batch rows / requests
  pp — pipeline parallel over layer stages (stacked [L, ...] weights and the
       KV cache split their leading layer dim)
  tp — tensor parallel over heads / ffn-hidden / vocab (innermost, so its
       per-token collectives stay among neighbouring ranks of one host)

Global rank r sits at (r // (pp * tp), (r // tp) % pp, r % tp). Each axis
is a `comm.Axis` over a process group made with `dist.new_group`; every
rank creates every group, in the same order, as torch.distributed requires,
and keeps its own. A rank's device is cuda:(local rank % cards), or the CPU.
A mesh in a single process (no process group) has every axis of size 1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import multihost
from .comm import Axis

AXES = ("dp", "pp", "tp")


@dataclass
class Mesh:
    """This rank's view of the mesh: the axes' sizes (`shape`, as JAX's
    Mesh.shape), its global rank, its device, and one `Axis` per name.
    `control` is a gloo group over every rank (None in one process) for
    host-side objects: the serving loop's messages."""

    shape: dict[str, int]
    rank: int
    device: torch.device
    axes: dict[str, Axis] = field(default_factory=dict)
    control: object | None = None

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["pp"] * self.shape["tp"]


def _sizes(n: int, tp, dp, pp: int) -> tuple[int, int, int]:
    """The JAX argument rules (mesh.py:21-33 there): unnamed sizes take the
    rest of the n ranks."""
    if tp is None and dp is None:
        tp, dp = n // pp, 1
    elif tp is None:
        tp = n // (dp * pp)
    elif dp is None:
        dp = n // (tp * pp)
    assert dp * pp * tp == n, f"dp({dp}) * pp({pp}) * tp({tp}) != n_devices({n})"
    return tp, dp, pp


def make_mesh(tp: int | None = None, dp: int | None = None, pp: int = 1,
              device="cuda") -> Mesh:
    """The mesh over the initialized world (`multihost.initialize`), or over
    this one process when no group is up. `device` is the device type of the
    ranks: "cuda" (each rank on cuda:(local rank % cards)) or "cpu"."""
    n = multihost.process_count()
    tp, dp, pp = _sizes(n, tp, dp, pp)
    rank = multihost.process_index()
    dev = multihost.local_device(device, rank)
    sizes = {"dp": dp, "pp": pp, "tp": tp}
    coord = {"dp": rank // (pp * tp), "pp": (rank // tp) % pp, "tp": rank % tp}
    gloo = n > 1 and dist.get_backend() == "gloo"
    host_copy = gloo and dev.type == "cuda"
    axes = {}
    for name in AXES:
        others = [a for a in AXES if a != name]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = tuple((at.get("dp", 0) if name != "dp" else i) * pp * tp
                          + (at.get("pp", 0) if name != "pp" else i) * tp
                          + (at.get("tp", 0) if name != "tp" else i)
                          for i in range(sizes[name]))
            group = dist.new_group(list(ranks)) if sizes[name] > 1 else None
            if rank in ranks:
                axes[name] = Axis(name, sizes[name], coord[name], ranks, group, host_copy)
    control = None
    if n > 1:
        control = dist.group.WORLD if gloo else dist.new_group(list(range(n)), backend="gloo")
    return Mesh(sizes, rank, dev, axes, control)

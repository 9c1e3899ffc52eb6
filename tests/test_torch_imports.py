"""The port stands alone: no module of `llamavk_tpu_torch` and not
`chip_smoke.py` imports JAX, the JAX package or the TPU probes of `tools/`,
and the entry points run on CUDA unless the caller asks for the CPU."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

from llamavk_tpu_torch import compat
from llamavk_tpu_torch.cli import embedding
from llamavk_tpu_torch.cli import generate as cli
from llamavk_tpu_torch.cli import perplexity
from llamavk_tpu_torch.cli import quantize_stats
from llamavk_tpu_torch.cli import serve
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.parallel import make_mesh, multihost
from llamavk_tpu_torch.runtime.batching import BatchedEngine
from llamavk_tpu_torch.runtime.engine import Engine
from llamavk_tpu_torch.runtime.server import LlamaServer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "llamavk_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
PROBES = ("bench_unpack_trick", "bench_int8_mxu", "bench_unpack2", "bench_i4_stacked",
          "bench_prefill_ownrows")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_sources_include_parallel():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for mod in ("comm", "mesh", "multihost", "sharding", "tp"):
        assert f"llamavk_tpu_torch/parallel/{mod}.py" in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "llamavk_tpu"), f"{path.name} imports {name}"


def test_sources_include_probes():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for mod in PROBES:
        assert f"llamavk_tpu_torch/tools/{mod}.py" in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_tools_imports(path):
    """The Hopper probes keep their own code: nothing imports the TPU probes
    (`tools`, `tools.*`)."""
    for name in _imported(path):
        assert name.split(".")[0] != "tools", f"{path.name} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    path = str(tmp_path / "tiny-q4.bin")
    tl.random_tiny_model(write_path=path, quantize=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.load_model(path)
    cfg, params, tok = tl.load_model(path, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.synthetic_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-m", path, "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaServer(cfg, params, tok)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["-m", path])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.local_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.llama_init_from_file(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        embedding.main(["-m", path])
    text = tmp_path / "text.raw"
    text.write_bytes(b"abc" * 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        perplexity.main(["-m", path, "-f", str(text)])
    for argv in ([], ["--device"]):  # the card by default, and for the JAX CLI's bare flag
        with pytest.raises(RuntimeError, match="CUDA"):
            quantize_stats.main(["-m", path, *argv])
    assert cli.build_argparser().parse_args(["-m", path]).device == "cuda"
    assert serve.build_argparser().parse_args(["-m", path]).device == "cuda"
    assert make_mesh(device="cpu").device.type == "cpu"
    assert embedding.build_argparser().parse_args(["-m", path]).device == "cuda"
    assert perplexity.build_argparser().parse_args(["-m", path, "-f", "t"]).device == "cuda"
    assert quantize_stats.build_argparser().parse_args(["-m", path]).device == "cuda"
    assert compat.llama_context_default_params().device == "cuda"
    # the CPU, when asked for, works
    assert Engine(cfg, params, device="cpu").cache.k.device.type == "cpu"
    assert BatchedEngine(cfg, params, device="cpu").cache.k.device.type == "cpu"
    assert LlamaServer(cfg, params, tok, device="cpu").engine.cache.k.device.type == "cpu"
    assert tl.synthetic_params(cfg, device="cpu").norm.device.type == "cpu"
    p = compat.llama_context_default_params()
    p.device, p.n_ctx = "cpu", 32
    assert compat.llama_init_from_file(path, p).engine.cache.k.device.type == "cpu"


@pytest.mark.parametrize("name", PROBES)
def test_probes_refuse_without_cuda(no_cuda, capsys, name):
    """A probe's entry point times CUDA kernels: without CUDA it refuses to
    start, unless given --device cpu, which runs its plain versions."""
    mod = importlib.import_module(f"llamavk_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit, match="GPU"):
        mod.main([])
    rows = mod.main(["--device", "cpu"])
    assert rows and all(r["ok"] and r["ms"] is None for r in rows)

"""The PyTorch port stands alone: no JAX, no flax, no optax, nothing of the
JAX package or of the JAX repo's ``scripts/``, and no ``transformers``, ``safetensors`` or ``ml_dtypes`` at module
level (the port needs none of them: only a tokenizer load imports
``transformers``); and it never falls back from a requested CUDA device to
the CPU."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import init_synthetic_params
from shadowkv_tpu_torch.models.registry import toy_config

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "shadowkv_tpu", "optax", "scripts"}
# Importable only inside the function that needs them (the tokenizer).
NOT_AT_MODULE_LEVEL = {"transformers", "safetensors", "ml_dtypes",
                       "tokenizers"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _module_level_roots(path: Path) -> set[str]:
    """Roots imported when the module is imported: every import outside a
    function body."""
    roots = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                roots.update(a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                roots.add(child.module.split(".")[0])
            visit(child)

    visit(ast.parse(path.read_text(), filename=str(path)))
    return roots


def _port_files() -> list[Path]:
    files = sorted((ROOT / "shadowkv_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for must in (
        "chip_smoke.py",
        "shadowkv_tpu_torch/config.py",
        "shadowkv_tpu_torch/kernels/reconstruct.py",
        "shadowkv_tpu_torch/kernels/gather.py",
        "shadowkv_tpu_torch/utils/profiling.py",
        "shadowkv_tpu_torch/kernels/prefill_attention.py",
        "shadowkv_tpu_torch/kernels/vs_tile.py",
        "shadowkv_tpu_torch/kernels/vs_sparse.py",
        "shadowkv_tpu_torch/core/minference.py",
        "shadowkv_tpu_torch/models/calibrate.py",
        "shadowkv_tpu_torch/models/engine.py",
        "shadowkv_tpu_torch/serving.py",
        "shadowkv_tpu_torch/core/wquant.py",
        "shadowkv_tpu_torch/models/params.py",
        "shadowkv_tpu_torch/models/registry.py",
        "shadowkv_tpu_torch/models/prompt_templates.py",
        "shadowkv_tpu_torch/models/llm.py",
        "shadowkv_tpu_torch/utils/checkpoint.py",
        "shadowkv_tpu_torch/data/dataset.py",
        "shadowkv_tpu_torch/data/metrics.py",
        "shadowkv_tpu_torch/data/wordlists.py",
        "shadowkv_tpu_torch/data/niah.py",
        "shadowkv_tpu_torch/data/longbench.py",
        "shadowkv_tpu_torch/data/viz.py",
        "shadowkv_tpu_torch/data/ruler/generate.py",
        "shadowkv_tpu_torch/data/ruler/prepare.py",
        "shadowkv_tpu_torch/eval/evaluator.py",
        "shadowkv_tpu_torch/entry/e2e.py",
        "shadowkv_tpu_torch/entry/eval_acc.py",
    ):
        assert must in names


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_module_level_hf_imports(path):
    bad = _module_level_roots(path) & NOT_AT_MODULE_LEVEL
    assert not bad, f"{path} imports {sorted(bad)} at module level"


def test_llm_cuda_without_gpu_raises():
    """``LLM`` runs on the card unless told otherwise, and refuses before
    it makes a weight."""
    from shadowkv_tpu_torch.models.llm import LLM

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLM("meta-llama/Meta-Llama-3.1-8B-Instruct")


def _toy_engine_args():
    cfg = toy_config(dtype=torch.float32, head_dim=128, hidden_size=256,
                     num_heads=4, num_kv_heads=2, intermediate_size=512)
    params = init_synthetic_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def test_engine_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal is moot")
    cfg, params = _toy_engine_args()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, CacheConfig(mode="full", max_length=64),
               RuntimeConfig(), params)  # device defaults to cuda


@pytest.mark.parametrize(
    "cache_kw, rt_kw",
    [
        # an int8 offloaded store with neither decode kernel
        (dict(mode="shadow_offload", kv_quant="int8"), dict()),
        (dict(mode="shadow"), dict(sp=2)),
        # the segmented offload prefill needs ring_gather
        (dict(mode="shadow_offload"),
         dict(use_pallas=True, offload_prefill_segments=2)),
        (dict(mode="full"), dict(tp=2)),
        (dict(mode="full"), dict(prefill_pattern="vs", vs_sim="uniform")),
        (dict(mode="full"), dict(pp=2)),
        # ... and shadow_offload
        (dict(mode="shadow"),
         dict(ring_gather=True, offload_prefill_segments=2)),
    ],
)
def test_unserved_settings_are_rejected(cache_kw, rt_kw):
    """A field the port lacks would be a TypeError; combinations the JAX
    engine rejects raise ValueError (pp over the full cache), and so does
    a tp mesh in a process with no process group to build it from."""
    served = {f.name for f in dataclasses.fields(RuntimeConfig)}
    if not set(rt_kw) <= served:
        with pytest.raises(TypeError):
            RuntimeConfig(**rt_kw)
        return
    cfg, params = _toy_engine_args()
    with pytest.raises(ValueError):
        Engine(cfg, CacheConfig(max_length=64, **cache_kw),
               RuntimeConfig(**rt_kw), params, device="cpu")


@pytest.mark.parametrize(
    "cache_kw, rt_kw",
    [
        (dict(mode="shadow_offload"), dict()),  # the HostVStore path
        (dict(mode="shadow_offload", kv_quant="int8"),
         dict(ring_gather=True, offload_prefill_segments=2)),
        (dict(mode="full"), dict(prefill_pattern="vs", vs_sim="clustered")),
        (dict(mode="shadow"), dict(decode_segmented=True)),
        (dict(mode="shadow"), dict(use_pallas=True, decode_segmented=True)),
    ],
)
def test_single_device_settings_are_served(cache_kw, rt_kw):
    """Every single-device setting of the JAX package builds an engine; a
    segment count that does not divide the layers is refused."""
    cfg, params = _toy_engine_args()
    eng = Engine(cfg, CacheConfig(max_length=64, **cache_kw),
                 RuntimeConfig(**rt_kw), params, device="cpu")
    assert eng.decode_segmented == bool(rt_kw.get("decode_segmented"))
    assert eng.host_store == (cache_kw["mode"] == "shadow_offload"
                              and not rt_kw.get("ring_gather"))
    if rt_kw.get("offload_prefill_segments"):
        with pytest.raises(ValueError, match="divide"):
            Engine(cfg, CacheConfig(max_length=64, **cache_kw),
                   RuntimeConfig(**dict(rt_kw, offload_prefill_segments=3)),
                   params, device="cpu")


def test_no_not_implemented_left_but_parallelism():
    """No ``NotImplementedError`` is left in the port: parallelism, its
    last one, is ported (``parallel/``), so ``LLM`` takes dp/tp/sp/pp."""
    hits = [p for p in _port_files() if "NotImplementedError" in p.read_text()]
    assert hits == []
    text = (ROOT / "shadowkv_tpu_torch/models/llm.py").read_text()
    assert "dp=dp, tp=tp, sp=sp, pp=pp" in text

"""Model-name -> ModelConfig dispatch, and ModelConfig from a local HF
checkpoint's ``config.json`` (counterpart of
``shadowkv_tpu/models/registry.py``; pure data)."""

from __future__ import annotations

import json
import os
from typing import Callable

from shadowkv_tpu_torch.config import ModelConfig

_REGISTRY: dict[str, Callable[..., ModelConfig]] = {}


def register_model(key: str):
    def deco(fn):
        _REGISTRY[key] = fn
        return fn

    return deco


def choose_model_config(name: str, **overrides) -> ModelConfig:
    lower = name.lower()
    for key, builder in _REGISTRY.items():
        if key in lower:
            return builder(name, **overrides)
    raise ValueError(f"no model family matches '{name}'")


@register_model("llama-3.1")
def llama31_8b(name: str, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        num_layers=32,
        hidden_size=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 8.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        max_position_embeddings=131072,
        **kw,
    )


@register_model("llama-3")
def llama3_8b(name: str, **kw) -> ModelConfig:
    lower = name.lower()
    is_1m = "1m" in lower or "1048k" in lower
    return ModelConfig(
        name=name,
        num_layers=32,
        hidden_size=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        vocab_size=128256,
        rope_theta=3580165449.0 if is_1m else 500000.0,
        max_position_embeddings=1048576 if is_1m else 8192,
        **kw,
    )


@register_model("yi")
def yi_9b(name: str, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        num_layers=48,
        hidden_size=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=11008,
        vocab_size=64000,
        rope_theta=10000000.0,
        max_position_embeddings=200000,
        **kw,
    )


@register_model("glm")
def glm4_9b(name: str, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        num_layers=40,
        hidden_size=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=13696,
        vocab_size=151552,
        rope_theta=100000000.0,
        rope_style="glm",
        rope_partial_dim=64,
        qkv_bias=True,
        rms_norm_eps=1.5625e-07,
        max_position_embeddings=1048576,
        **kw,
    )


@register_model("qwen")
def qwen2_7b(name: str, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        num_layers=28,
        hidden_size=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        vocab_size=152064,
        rope_theta=1000000.0,
        qkv_bias=True,
        rms_norm_eps=1e-6,
        max_position_embeddings=131072,
        **kw,
    )


@register_model("phi")
def phi3_mini(name: str, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        num_layers=32,
        hidden_size=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        intermediate_size=8192,
        vocab_size=32064,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
        max_position_embeddings=131072,
        **kw,
    )


def config_from_hf_dir(model_dir: str, name: str | None = None,
                       **overrides) -> ModelConfig:
    """Build a ModelConfig from a local HF checkpoint's config.json (a plain
    JSON read, so any local checkpoint, tiny test models included, resolves
    without a registry entry): GLM's partial interleaved RoPE and bias,
    Qwen2's qkv bias, and ``rope_scaling`` passed through."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or [""])[0].lower()
    heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // heads
    kw = dict(
        name=name or hf.get("_name_or_path") or model_dir,
        num_layers=hf["num_hidden_layers"],
        hidden_size=hf["hidden_size"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 131072),
    )
    if isinstance(hf.get("rope_scaling"), dict):
        kw["rope_scaling"] = hf["rope_scaling"]
    if "glm" in arch:
        kw.update(rope_style="glm", rope_partial_dim=head_dim // 2,
                  qkv_bias=hf.get("attention_bias", True))
    elif "qwen2" in arch:
        kw.update(qkv_bias=True)
    kw.update(overrides)
    return ModelConfig(**kw)


def toy_config(**kw) -> ModelConfig:
    """Small GQA llama-style config for CPU tests."""
    defaults = dict(
        name="toy-llama",
        num_layers=2,
        hidden_size=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        intermediate_size=256,
        vocab_size=512,
        rope_theta=10000.0,
        max_position_embeddings=8192,
    )
    defaults.update(kw)
    return ModelConfig(**defaults)

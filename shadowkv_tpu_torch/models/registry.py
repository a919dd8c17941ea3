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


@register_model("k-exaone")
def k_exaone_236b(name: str, **kw) -> ModelConfig:
    """K-EXAONE-236B-A23B (LGAI-EXAONE/K-EXAONE-236B-A23B): 48 layers in
    the pattern LLLG (window 128, RoPE; global layers NoPE), QK-norm,
    post-norm blocks, layer 0 dense and 47 MoE layers of 128 experts, top
    8, one shared. Its multi-token-prediction layer only drafts for
    speculative decoding and is not served. ``held_experts`` gives a
    device's share of an expert-parallel deployment."""
    return ModelConfig(
        name=name,
        num_layers=48,
        hidden_size=6144,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=18432,
        vocab_size=153600,
        rope_theta=1000000.0,
        rms_norm_eps=1e-5,
        max_position_embeddings=262144,
        layer_types=(("sliding_attention",) * 3 + ("full_attention",)) * 12,
        sliding_window=128,
        exaone4_block=True,
        mlp_layer_types=("dense",) + ("sparse",) * 47,
        moe_intermediate_size=2048,
        num_experts=128,
        num_experts_per_tok=8,
        num_shared_experts=1,
        routed_scaling_factor=2.5,
        **kw,
    )


def _exaone_kw(hf: dict) -> dict:
    """The hybrid keys of an EXAONE 4 / K-EXAONE ``config.json``: layer
    kinds and window (global layers NoPE where a window exists), QK-norm,
    the post-norm block, and the MoE block of ``exaone_moe`` (DeepSeek-V3's
    sigmoid router; group routing is refused)."""
    n = hf["num_hidden_layers"]
    kw = dict(exaone4_block=True)
    types = hf.get("layer_types")
    if types is None and hf.get("sliding_window_pattern"):
        pat = hf["sliding_window_pattern"]
        types = ["sliding_attention" if pat[i % len(pat)] == "L"
                 else "full_attention" for i in range(n)]
    if types is not None and "sliding_attention" in types:
        kw.update(layer_types=tuple(types),
                  sliding_window=hf["sliding_window"])
    rope = hf.get("rope_parameters") or {}
    if "rope_theta" in rope:
        kw["rope_theta"] = float(rope["rope_theta"])
    if hf.get("num_experts"):
        if hf.get("scoring_func", "sigmoid") != "sigmoid" or hf.get(
                "n_group", 1) != 1 or hf.get("topk_group", 1) != 1:
            raise ValueError("the port's router is the sigmoid router "
                             "without expert groups")
        mlp = hf.get("mlp_layer_types") or [
            "dense" if i < hf.get("first_k_dense_replace", 0) else "sparse"
            for i in range(n)]
        kw.update(
            mlp_layer_types=tuple(mlp),
            moe_intermediate_size=hf["moe_intermediate_size"],
            num_experts=hf["num_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            num_shared_experts=hf.get("num_shared_experts", 0),
            routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
            norm_topk_prob=bool(hf.get("norm_topk_prob", True)))
    return kw


def config_from_hf_dir(model_dir: str, name: str | None = None,
                       **overrides) -> ModelConfig:
    """Build a ModelConfig from a local HF checkpoint's config.json (a plain
    JSON read, so any local checkpoint, tiny test models included, resolves
    without a registry entry): GLM's partial interleaved RoPE and bias,
    Qwen2's qkv bias, EXAONE's hybrid and MoE keys, and ``rope_scaling``
    passed through."""
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
    elif "exaone" in arch or "exaone" in hf.get("model_type", ""):
        kw.update(_exaone_kw(hf))
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

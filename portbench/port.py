"""The port's objects built from a configuration file and the benchmark's
drawn weights: the only place besides the traffic drivers that imports
``shadowkv_tpu_torch``."""

from __future__ import annotations

from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core.layers import LayerParams, ModelParams
from shadowkv_tpu_torch.models.engine import Engine

from portbench.weights import dtype_of

_MODEL_KEYS = ("num_layers", "hidden_size", "num_heads", "num_kv_heads",
               "head_dim", "intermediate_size", "vocab_size", "rms_norm_eps",
               "rope_theta", "rope_style", "rope_partial_dim", "qkv_bias",
               "max_position_embeddings")


def model_config(cfg: dict) -> ModelConfig:
    md = cfg["model"]
    return ModelConfig(name=cfg["name"], dtype=dtype_of(md),
                       **{k: md[k] for k in _MODEL_KEYS if k in md})


def model_params(w: dict) -> ModelParams:
    layers = LayerParams(
        attn_norm=w["attn_norm"], wqkv=w["wqkv"], bqkv=w.get("bqkv"),
        wo=w["wo"], mlp_norm=w["mlp_norm"], w_gate_up=w["w_gate_up"],
        w_down=w["w_down"])
    return ModelParams(embed=w["embed"], layers=layers,
                       final_norm=w["final_norm"], lm_head=w["lm_head"])


def engine(cfg: dict, w: dict, sketch, max_length: int, device) -> Engine:
    """An engine over the drawn weights (no copy) with the configuration's
    cache and runtime settings, for prompts of up to ``max_length``."""
    cache = CacheConfig(max_length=max_length, **cfg["cache"])
    rt = RuntimeConfig(**cfg["runtime"])
    return Engine(model_config(cfg), cache, rt, model_params(w),
                  device=device, sketch=sketch)

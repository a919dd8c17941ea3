"""The port's objects for a hybrid configuration (K-EXAONE's
``exaone_moe`` keys at the configuration file's top level, as its
``config.json`` has them) and the drawn weights of
``portbench/weights_hybrid.py``: with ``portbench/port.py`` and the
traffic drivers, the only modules that import ``shadowkv_tpu_torch``."""

from __future__ import annotations

from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.models.engine import Engine

from portbench.weights import dtype_of
from portbench.weights_hybrid import mlp_types


def model_config(cfg: dict) -> ModelConfig:
    """The sliding layers rotate (rotate-half), the full-attention layers
    are NoPE, q and k are RMS-normalised per head, the blocks post-norm (the
    EXAONE 4 block); the router spans the published experts, of which this
    device holds ``held_experts``."""
    return ModelConfig(
        name=cfg["name"], dtype=dtype_of(cfg["model"]),
        num_layers=cfg["num_hidden_layers"], hidden_size=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        intermediate_size=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_parameters"]["rope_theta"]),
        max_position_embeddings=cfg["max_position_embeddings"],
        layer_types=tuple(cfg["layer_types"]),
        sliding_window=cfg["sliding_window"], exaone4_block=True,
        mlp_layer_types=tuple(mlp_types(cfg)),
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_experts=cfg["num_experts_published"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        num_shared_experts=cfg["num_shared_experts"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        norm_topk_prob=bool(cfg["norm_topk_prob"]),
        held_experts=tuple(cfg["held_experts"]))


def engine(cfg: dict, w: dict, sketch, max_length: int, device) -> Engine:
    """An engine over the drawn weights (no copy) with the configuration's
    cache and runtime settings, for prompts of up to ``max_length``."""
    md = model_config(cfg)
    cache = CacheConfig(max_length=max_length, **cfg["cache"])
    rt = RuntimeConfig(**cfg["runtime"])
    return Engine(md, cache, rt, ModelParams.from_tensors(w, md),
                  device=device, sketch=sketch)

"""Model FLOPs of one hybrid decode step of one row (a configuration of
K-EXAONE's keys): 2 x the matmul parameters the row uses, that is every
layer's q, k, v and o projections, the dense layers' MLPs, each MoE
layer's router, shared expert and the held experts the row chose, and the
output head; plus attention, 4 x heads x head_dim per attended position:
a global layer at gen depth ``d`` attends ShadowKV's compact buffer (the
local rows, the outlier chunks, the selected budget and the ``d + 1``
rows of its round), a sliding layer its window."""

import numpy as np


def hybrid_step_flops(cfg: dict, lay, depth: int, chosen: np.ndarray) -> int:
    """chosen [Lm, k]: the row's chosen expert ids per MoE layer."""
    d = cfg["hidden_size"]
    h, kh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    ie, i_d = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    types = cfg["mlp_layer_types"]
    n_dense = sum(t == "dense" for t in types)
    n_moe = len(types) - n_dense
    attn_proj = d * (h + 2 * kh) * dh + h * dh * d
    held = np.isin(chosen, cfg["held_experts"]).sum()
    mm = (len(types) * attn_proj + n_dense * 3 * d * i_d
          + n_moe * (d * cfg["num_experts_published"]
                     + 3 * d * ie * cfg["num_shared_experts"])
          + int(held) * 3 * d * ie + d * cfg["vocab_size"])
    n_global = sum(t == "full_attention" for t in cfg["layer_types"])
    n_slide = len(cfg["layer_types"]) - n_global
    attended = n_global * (lay.static_rows + lay.sets * lay.chunk + depth + 1) \
        + n_slide * min(cfg["sliding_window"], lay.prompt_len + depth + 1)
    return 2 * mm + 4 * h * dh * attended

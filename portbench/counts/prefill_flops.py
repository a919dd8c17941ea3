"""Model FLOPs of one dense prefill of ``s`` tokens (one row): 2 x the
layers' matmul parameters per token, the output head on the last token,
and causal attention, 4 x s(s+1)/2 x head_dim x heads per layer."""

from portbench.counts.attn_b_flops import causal_attention_flops
from portbench.counts.matmul_params import (head_matmul_params,
                                            layer_matmul_params)


def prefill_flops(model: dict, s: int) -> int:
    mm = 2 * model["num_layers"] * layer_matmul_params(model) * s \
        + 2 * head_matmul_params(model)
    return mm + model["num_layers"] * causal_attention_flops(model, s)

"""Operations of one causal prefill attention launch (kernel B) over one
row of ``s`` tokens: 4 x s(s+1)/2 x head_dim x heads (QK^T and PV over the
causal pairs)."""


def causal_attention_flops(model: dict, s: int, rows: int = 1) -> int:
    return 4 * (s * (s + 1) // 2) * model["head_dim"] * model["num_heads"] \
        * rows

"""Matmul parameters of one decoder layer and of the output head."""


def layer_matmul_params(model: dict) -> int:
    d, i = model["hidden_size"], model["intermediate_size"]
    q = model["num_heads"] * model["head_dim"]
    kv = model["num_kv_heads"] * model["head_dim"]
    return d * (q + 2 * kv) + q * d + d * 2 * i + i * d


def head_matmul_params(model: dict) -> int:
    return model["hidden_size"] * model["vocab_size"]

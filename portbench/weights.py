"""The benchmark's inputs, drawn from ``--seed``: the weights (on the
device, in the dtype they are served in, one call per stacked tensor), the
low-rank sketch, and token ids. Both the port and the plain reference take
these; the reference reads them as a plain dict of tensors.

Weights are N(0, std) with the output projections (``wo``, ``w_down``)
scaled by 1/sqrt(2 * layers), as GPT-2 and Megatron initialise them, so the
residual stream of a deep random model stays near its size at every layer;
the RMSNorm gains are 1, and the qkv bias, where the model has one, is
N(0, bias_std)."""

from __future__ import annotations

import math

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(model: dict) -> torch.dtype:
    return _DTYPES[model["dtype"]]


def qkv_width(model: dict) -> int:
    return (model["num_heads"] + 2 * model["num_kv_heads"]) * model["head_dim"]


def draw_weights(model: dict, init: dict, seed: int, device) -> dict:
    """{name: tensor} with layer leaves stacked [L, ...] and [in, out]
    matmul layout: embed [V, D], attn_norm / mlp_norm [L, D], wqkv [L, D,
    (H+2K)Dh], bqkv [L, (H+2K)Dh] (or absent), wo [L, H*Dh, D], w_gate_up
    [L, D, 2I] (gate then up), w_down [L, I, D], final_norm [D], lm_head
    [D, V]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(model)
    l, d, i = model["num_layers"], model["hidden_size"], model["intermediate_size"]
    std = init["std"]
    out_std = std / math.sqrt(2 * l)

    def rnd(shape, s):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, s, generator=gen)

    w = {
        "embed": rnd((model["vocab_size"], d), std),
        "wqkv": rnd((l, d, qkv_width(model)), std),
        "wo": rnd((l, model["num_heads"] * model["head_dim"], d), out_std),
        "w_gate_up": rnd((l, d, 2 * i), std),
        "w_down": rnd((l, i, d), out_std),
        "lm_head": rnd((d, model["vocab_size"]), std),
        "attn_norm": torch.ones((l, d), dtype=dt, device=device),
        "mlp_norm": torch.ones((l, d), dtype=dt, device=device),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if model["qkv_bias"]:
        w["bqkv"] = rnd((l, qkv_width(model)), init["bias_std"])
    return w


def draw_sketch(model: dict, cache: dict, seed: int, device) -> torch.Tensor:
    """The Gaussian sketch [K*Dh, min(K*Dh, rank + 32)] (f32) of the
    low-rank build, from its own generator so that it does not depend on
    the weights' draw."""
    d = model["num_kv_heads"] * model["head_dim"]
    p = min(d, cache["rank"] + 32)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EC7)
    return torch.randn(d, p, generator=gen, device=device, dtype=torch.float32)


def token_gen(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` per input stream of one seed, for
    ids drawn on the card while the window runs."""
    return torch.Generator(device=device).manual_seed((seed << 4) | stream)


def token_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per input stream (prompts, questions,
    sample choices) of one seed."""
    return np.random.default_rng([seed, stream])

"""The weights of a hybrid configuration (K-EXAONE's ``exaone_moe`` keys),
drawn on the device from ``--seed``, one call per stacked tensor, in the
layout both the port (``core/layers.py::ModelParams.from_tensors``) and
the plain reference (``reference/k_exaone.py``) read: the attention and
norm leaves stacked over every layer, the dense MLPs over the dense layers,
the MoE leaves over the MoE layers, the routed experts those of
``held_experts`` only (this device's share).

A post-norm block (no input norm) projects the raw residual, whose size
grows with depth: each block adds two RMS-normalised branches, so before
layer l's attention the residual's RMS is about sqrt(2 l) and before its
MLP about sqrt(2 l + 1). The matrices that read it are scaled down by
those factors (``init.std`` over them), so their outputs stay in scale at
every depth, and the router's (``init.router_std``) so that its logits
keep a spread of about 1 and the sigmoid scores do not saturate into ties;
``e_bias`` is N(0, ``init.bias_std``), small beside the scores, so that the
biased choice and the unbiased weights differ. Output projections are
N(0, ``init.std``) (the post-norms rescale them); every RMSNorm gain is 1.
The router and its bias are float32, as the router computes; the rest is in
the configuration's dtype."""

from __future__ import annotations

import math

import torch

from portbench.weights import dtype_of


def mlp_types(cfg: dict) -> list:
    return ["dense" if t == "dense" else "sparse"
            for t in cfg["mlp_layer_types"]]


def draw_hybrid(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg["model"])
    init = cfg["init"]
    std = init["std"]
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    types = mlp_types(cfg)
    dense = [i for i, t in enumerate(types) if t == "dense"]
    moe = [i for i, t in enumerate(types) if t == "sparse"]
    e_all, eh = cfg["num_experts_published"], len(cfg["held_experts"])
    ie = cfg["moe_intermediate_size"]
    i_s = ie * cfg["num_shared_experts"]
    i_d = cfg["intermediate_size"]

    def rnd(shape, s, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, s, generator=gen)

    def per_layer(t, layers, scale):
        """t [len(layers), ...] scaled by scale(l) per layer, in place."""
        f = torch.tensor([scale(l) for l in layers], device=device,
                         dtype=torch.float32)
        return t.mul_(f.view(-1, *[1] * (t.dim() - 1)).to(t.dtype))

    def attn_in(l):
        return 1.0 / math.sqrt(max(1, 2 * l))

    def mlp_in(l):
        return 1.0 / math.sqrt(2 * l + 1)

    layers = list(range(n))
    w = {
        "embed": rnd((cfg["vocab_size"], d), std),
        "wqkv": per_layer(rnd((n, d, (h + 2 * kh) * dh), std), layers,
                          attn_in),
        "wo": rnd((n, h * dh, d), std),
        "q_norm": torch.ones((n, dh), dtype=dt, device=device),
        "k_norm": torch.ones((n, dh), dtype=dt, device=device),
        "post_attn_norm": torch.ones((n, d), dtype=dt, device=device),
        "post_mlp_norm": torch.ones((n, d), dtype=dt, device=device),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "lm_head": rnd((d, cfg["vocab_size"]), std),
    }
    if dense:
        w["dense_gate_up"] = per_layer(rnd((len(dense), d, 2 * i_d), std),
                                       dense, mlp_in)
        w["dense_down"] = rnd((len(dense), i_d, d), std)
    if moe:
        w["router"] = per_layer(
            rnd((len(moe), d, e_all), init["router_std"], torch.float32),
            moe, mlp_in)
        w["e_bias"] = rnd((len(moe), e_all), init["bias_std"], torch.float32)
        w["experts_gate_up"] = rnd((len(moe), eh, d, 2 * ie), std)
        for j, l in enumerate(moe):
            w["experts_gate_up"][j].mul_(mlp_in(l))
        w["experts_down"] = rnd((len(moe), eh, ie, d), std)
        w["shared_gate_up"] = per_layer(rnd((len(moe), d, 2 * i_s), std),
                                        moe, mlp_in)
        w["shared_down"] = rnd((len(moe), i_s, d), std)
    return w

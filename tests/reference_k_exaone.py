"""Plain float32 reference of K-EXAONE's decoder (LGAI-EXAONE/K-EXAONE-236B-A23B,
``exaone_moe``): the block of EXAONE 4.0 (transformers
``models/exaone4/modeling_exaone4.py``) with DeepSeek-V3's MoE
(``models/deepseek_v3/modeling_deepseek_v3.py``: ``DeepseekV3TopkRouter``,
``DeepseekV3MoE``), written from those descriptions with plain torch
operations, no cache and no kernels. Nothing here imports the port.

Per layer, with no input norm:

- q, k, v projected from the raw residual; per-head RMSNorm of q and of k
  over the head's lanes (own gains); rotary embedding (rotate-half, base
  ``rope_theta``) on sliding layers only (full-attention layers are NoPE);
  causal attention, a sliding layer's query at position i seeing keys
  i - W + 1 .. i;
- x = x + RMSNorm(o_proj(attn));
- x = x + RMSNorm(mlp(x)), the MLP a SwiGLU (dense layers) or the MoE:
  s = sigmoid(x W_r) in float32, the chosen experts the top k of s + bias,
  weights s[chosen] / (sum + 1e-20) * routed_scaling_factor, the result the
  weighted sum of the chosen experts held here (all by default) plus the
  shared expert.

Then a final RMSNorm and the untied output head. ``routes`` makes the MoE
layers take given expert choices (another run's) instead of their own; the
weights are always this run's own scores of the chosen experts.

Weights are a dict: ``embed`` [V, D]; per layer [L, ...] ``wqkv`` [D, (H +
2K) Dh], ``wo``, ``q_norm`` / ``k_norm`` [Dh], ``post_attn_norm`` /
``post_mlp_norm`` [D]; per dense layer [Ld, ...] ``dense_gate_up`` [D, 2 I]
(gate, then up) and ``dense_down``; per MoE layer [Lm, ...] ``router`` [D,
E], ``e_bias`` [E], ``experts_gate_up`` [Eh, D, 2 Ie] / ``experts_down`` of
the held experts ``held`` (ids, in order), ``shared_gate_up`` /
``shared_down``; ``final_norm``, ``lm_head`` [D, V].
"""

from __future__ import annotations

import math

import torch


def rms_norm(x, g, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope(x, positions, theta):
    """Rotate-half RoPE of x [N, heads, Dh] at ``positions`` [N] (angles
    in float64)."""
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    ang = positions.double()[:, None] * inv[None].to(positions.device)
    c, s = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, window=None, block=256):
    """Causal GQA attention q [S, H, Dh], k/v [S, K, Dh] -> [S, H, Dh];
    with ``window`` a query at i sees keys i - window + 1 .. i only."""
    s, h, dh = q.shape
    kh = k.shape[1]
    g = h // kh
    out = torch.empty(s, h, dh, dtype=torch.float32, device=q.device)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        qb = q[i0:i1].float().view(i1 - i0, kh, g, dh)
        sc = torch.einsum("ikgd,jkd->kgij", qb, k[j0:i1].float())
        sc = sc / math.sqrt(dh)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None]
        seen = kj <= qi
        if window is not None:
            seen = seen & (qi - kj < window)
        sc = sc.masked_fill(~seen, float("-inf")).softmax(-1)
        o = torch.einsum("kgij,jkd->ikgd", sc, v[j0:i1].float())
        out[i0:i1] = o.reshape(i1 - i0, h, dh)
    return out


def swiglu(x, gate_up, down):
    gate, up = (x.float() @ gate_up.float()).chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up) @ down.float()


def router(md, w, m, x):
    """(scores s [N, E], this run's own choice [N, k]) of MoE layer m."""
    s = torch.sigmoid(x.float() @ w["router"][m].float())
    own = (s + w["e_bias"][m].float()).topk(md["num_experts_per_tok"],
                                           dim=-1).indices
    return s, own


def moe(md, w, m, x, chosen=None):
    """MoE layer m of rows x [N, D]: (output [N, D], own choice [N, k],
    scores [N, E]). ``chosen`` [N, k] replaces the own choice."""
    s, own = router(md, w, m, x)
    top = own if chosen is None else chosen.long()
    wt = s.gather(-1, top)
    if md["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * md["routed_scaling_factor"]
    out = swiglu(x, w["shared_gate_up"][m], w["shared_down"][m])
    for j, e in enumerate(w["held"]):
        tok, slot = (top == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], w["experts_gate_up"][m][j],
                       w["experts_down"][m][j])
            out.index_add_(0, tok, y * wt[tok, slot, None])
    return out, own, s


def route_regret(scores, bias, chosen):
    """The share of the best top-k mass of ``scores + bias`` [N, E] that a
    chosen set [N, k] misses, the worst over rows."""
    b = scores.float() + bias.float()
    top = b.topk(chosen.shape[-1], dim=-1).values.sum(-1)
    got = b.gather(-1, chosen.long()).sum(-1)
    return float(((top - got) / top).max())


def forward(md, w, ids, routes=None, keep_keys=False):
    """Logits [S, V] (f32) of token ids [S] at positions 0..S-1. ``routes``
    {MoE layer index: chosen [S, k]} makes those layers follow them.
    Returns (logits, info): info ``own`` {m: own choice [S, k]}, ``scores``
    {m: [S, E]}, and with ``keep_keys`` ``keys`` {layer: k [S, K, Dh] as
    attended (after QK-norm, rotated on sliding layers)}."""
    H, K, Dh = md["num_heads"], md["num_kv_heads"], md["head_dim"]
    eps, win = md["rms_norm_eps"], md["sliding_window"]
    s = ids.shape[0]
    pos = torch.arange(s, device=ids.device)
    x = w["embed"][ids].float()
    info = {"own": {}, "scores": {}, "keys": {}}
    d = m = 0
    for layer, kind in enumerate(md["layer_types"]):
        sliding = kind == "sliding_attention"
        y = x @ w["wqkv"][layer].float()
        q, k, v = y.split([H * Dh, K * Dh, K * Dh], dim=-1)
        q = rms_norm(q.view(s, H, Dh), w["q_norm"][layer], eps)
        k = rms_norm(k.view(s, K, Dh), w["k_norm"][layer], eps)
        if sliding:
            q, k = rope(q, pos, md["rope_theta"]), rope(k, pos,
                                                         md["rope_theta"])
        if keep_keys:
            info["keys"][layer] = k
        ctx = attention(q, k, v.view(s, K, Dh), win if sliding else None)
        o = ctx.reshape(s, -1) @ w["wo"][layer].float()
        x = x + rms_norm(o, w["post_attn_norm"][layer], eps)
        if md["mlp_layer_types"][layer] == "dense":
            y = swiglu(x, w["dense_gate_up"][d], w["dense_down"][d])
            d += 1
        else:
            y, own, sc = moe(md, w, m, x,
                             None if routes is None else routes[m])
            info["own"][m], info["scores"][m] = own, sc
            m += 1
        x = x + rms_norm(y, w["post_mlp_norm"][layer], eps)
    h = rms_norm(x, w["final_norm"], eps)
    return h @ w["lm_head"].float(), info

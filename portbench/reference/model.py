"""Plain PyTorch pieces of the served decoder block, computed in float32
(TF32 off), from the published descriptions of the two families the cells
run:

- GLM-4 (``THUDM/glm-4-9b-chat-1m``, ChatGLM's modeling code): RMSNorm, a
  fused QKV projection with bias, rotary embedding over the first half of
  each head (64 of 128 lanes) in interleaved (even, odd) pairs with base
  10000 * rope_ratio, grouped-query attention, a bias-free output
  projection, SwiGLU (the first half of ``dense_h_to_4h`` gated by SiLU,
  times the second half), a final RMSNorm and an untied output layer;
- Yi (``01-ai/Yi-9B-200K``, Llama's modeling code): the same block without
  the bias, rotary embedding over the whole head in rotate-half form.

``prec="fp8"`` is the control: every matmul of the model (projections and
the output head) takes operands rounded to float8 e4m3, activations per
row and weights per output column, each scaled by its largest magnitude
over 448, and multiplies them in float32. Nothing here imports the port.
"""

from __future__ import annotations

import math

import torch

F8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``'s
    complement (the largest magnitude along ``dim`` maps to 448)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x [..., in] @ w [in, out] in float32 (operands rounded to fp8 under
    ``prec="fp8"``)."""
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope_tables(model: dict, positions: torch.Tensor):
    """(cos, sin) [N, rot/2] float32 of ``positions`` [N], the angles taken
    in float64 (an f32 angle at position 1e5 is off by ~1e-2 rad)."""
    rot = model.get("rope_partial_dim") or model["head_dim"]
    j = torch.arange(0, rot, 2, dtype=torch.float64, device=positions.device)
    inv = model["rope_theta"] ** (-j / rot)
    ang = positions.double()[:, None] * inv[None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str) -> torch.Tensor:
    """Rotate x [N, heads, Dh] at the rows' positions (cos/sin [N, rot/2])."""
    half = cos.shape[-1]
    c, s = cos[:, None], sin[:, None]
    if style == "neox":  # rotate-half over the whole head
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if style == "glm":  # interleaved pairs over the first 2*half lanes
        rot = 2 * half
        ev, od = x[..., 0:rot:2], x[..., 1:rot:2]
        r = torch.stack([ev * c - od * s, od * c + ev * s], dim=-1)
        return torch.cat([r.flatten(-2), x[..., rot:]], dim=-1)
    raise ValueError(f"unknown rope style {style!r}")


def qkv(model: dict, w: dict, layer: int, h: torch.Tensor, prec: str):
    """q [N, H, Dh], k [N, K, Dh], v [N, K, Dh] (pre-RoPE) of normed rows."""
    H, K, Dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    y = linear(h, w["wqkv"][layer], prec)
    if "bqkv" in w:
        y = y + w["bqkv"][layer].float()
    q, k, v = y.split([H * Dh, K * Dh, K * Dh], dim=-1)
    n = h.shape[0]
    return q.view(n, H, Dh), k.view(n, K, Dh), v.view(n, K, Dh)


def block_tail(model: dict, w: dict, layer: int, x: torch.Tensor,
               ctx: torch.Tensor, prec: str) -> torch.Tensor:
    """Output projection, residual, SwiGLU MLP, residual; ctx [N, H, Dh]."""
    x = x + linear(ctx.reshape(x.shape[0], -1), w["wo"][layer], prec)
    h = rms_norm(x, w["mlp_norm"][layer], model["rms_norm_eps"])
    gate, up = linear(h, w["w_gate_up"][layer], prec).chunk(2, dim=-1)
    return x + linear(torch.nn.functional.silu(gate) * up,
                      w["w_down"][layer], prec)


def logits(model: dict, w: dict, x: torch.Tensor, prec: str,
           block: int = 256) -> torch.Tensor:
    """Final norm and output head of rows x [N, D] -> [N, V] float32."""
    out = []
    for i in range(0, x.shape[0], block):
        h = rms_norm(x[i:i + block], w["final_norm"], model["rms_norm_eps"])
        out.append(linear(h, w["lm_head"], prec))
    return torch.cat(out)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """Causal GQA attention of S rows: q [S, H, Dh], k/v [S, K, Dh] ->
    [S, H, Dh]; query blocks of ``block`` rows against the keys up to the
    block's end."""
    s, hq, dh = q.shape
    kh = k.shape[1]
    g = hq // kh
    scale = 1.0 / math.sqrt(dh)
    qg = q.view(s, kh, g, dh).permute(1, 2, 0, 3)  # [K, G, S, Dh]
    kt = k.permute(1, 0, 2)  # [K, S, Dh]
    vt = v.permute(1, 0, 2)
    out = torch.empty(kh, g, s, dh, dtype=torch.float32, device=q.device)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        sc = torch.einsum("kgid,kjd->kgij", qg[:, :, i0:i1], kt[:, :i1])
        sc = sc * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None]
        sc.masked_fill_(kj > qi, float("-inf"))
        out[:, :, i0:i1] = torch.einsum("kgij,kjd->kgid", sc.softmax(-1),
                                        vt[:, :i1])
    return out.permute(2, 0, 1, 3).reshape(s, hq, dh)

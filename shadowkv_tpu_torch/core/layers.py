"""Transformer layer building blocks (counterpart of
``shadowkv_tpu/core/layers.py``).

Parameters for all layers are stacked along a leading layer axis, with the
JAX package's leaf names and [in, out] matmul layout, so weights carry over
leaf by leaf (``models/params.py::from_jax_params``). A matmul leaf may be
an int8 ``QTensor`` (``core/wquant.py``); every product goes through
``wquant.mat`` and stays ``torch.matmul``, as the JAX package leaves it to
XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from shadowkv_tpu_torch.core.wquant import QTensor, Weight, mat


class LayerParams(NamedTuple):
    """Weights of the transformer blocks, stacked [L, ...]."""

    attn_norm: torch.Tensor  # [D]
    wqkv: Weight  # [D, (H + 2K) * Dh]
    bqkv: Optional[torch.Tensor]  # [(H + 2K) * Dh] or None
    wo: Weight  # [H * Dh, D]
    mlp_norm: torch.Tensor  # [D]
    w_gate_up: Weight  # [D, 2 * I]
    w_down: Weight  # [I, D]


class ModelParams(NamedTuple):
    embed: Weight  # [V, D] (row-quantized when a QTensor)
    layers: LayerParams  # leaves stacked [L, ...]
    final_norm: torch.Tensor  # [D]
    lm_head: Weight  # [D, V]

    def to(self, device) -> "ModelParams":
        return ModelParams(
            embed=self.embed.to(device),
            layers=LayerParams(*(
                None if t is None else t.to(device) for t in self.layers
            )),
            final_norm=self.final_norm.to(device),
            lm_head=self.lm_head.to(device),
        )

    def layer(self, i: int) -> LayerParams:
        """Layer ``i``'s weights (views of the stacked tensors)."""
        return LayerParams(*(
            None if t is None else t.layer(i) if isinstance(t, QTensor)
            else t[i] for t in self.layers
        ))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 math, output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def qkv_proj(
    x: torch.Tensor,
    layer: LayerParams,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused QKV projection of normed x [B, S, D] -> q [B, S, H, Dh],
    k/v [B, S, K, Dh]."""
    b, s = x.shape[:2]
    qkv = mat(x, layer.wqkv)
    if layer.bqkv is not None:
        qkv = qkv + layer.bqkv.to(qkv.dtype)
    q_size = num_heads * head_dim
    kv_size = num_kv_heads * head_dim
    q, k, v = torch.split(qkv, [q_size, kv_size, kv_size], dim=-1)
    return (
        q.reshape(b, s, num_heads, head_dim),
        k.reshape(b, s, num_kv_heads, head_dim),
        v.reshape(b, s, num_kv_heads, head_dim),
    )


def o_proj(attn_out: torch.Tensor, layer: LayerParams) -> torch.Tensor:
    """[B, S, H, Dh] -> [B, S, D]."""
    b, s = attn_out.shape[:2]
    return mat(attn_out.reshape(b, s, -1), layer.wo)


def swiglu_mlp(x: torch.Tensor, layer: LayerParams) -> torch.Tensor:
    """SwiGLU MLP with the fused gate/up projection (silu in f32)."""
    gate, up = torch.chunk(mat(x, layer.w_gate_up), 2, dim=-1)
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return mat(hidden, layer.w_down)

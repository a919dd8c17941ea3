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

from shadowkv_tpu_torch.core.moe import MoELayer, MoEParams
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


class BlockNorms(NamedTuple):
    """The norms of EXAONE 4's block (``ModelConfig.exaone4_block``),
    stacked [L, ...]."""

    q_norm: torch.Tensor  # [Dh]
    k_norm: torch.Tensor  # [Dh]
    post_attn_norm: torch.Tensor  # [D]
    post_mlp_norm: torch.Tensor  # [D]


class Block(NamedTuple):
    """One layer's weights (views): the ``LayerParams`` leaves, of which an
    MoE layer has no MLP, then EXAONE 4's norms and the MoE layer
    (``core/moe.py``) where the model has them."""

    attn_norm: Optional[torch.Tensor]
    wqkv: Weight
    bqkv: Optional[torch.Tensor]
    wo: Weight
    mlp_norm: Optional[torch.Tensor]
    w_gate_up: Optional[Weight]
    w_down: Optional[Weight]
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None
    post_attn_norm: Optional[torch.Tensor] = None
    post_mlp_norm: Optional[torch.Tensor] = None
    moe: Optional[MoELayer] = None


class ModelParams(NamedTuple):
    embed: Weight  # [V, D] (row-quantized when a QTensor)
    layers: LayerParams  # leaves stacked [L, ...]
    final_norm: torch.Tensor  # [D]
    lm_head: Weight  # [D, V]
    # EXAONE 4's norms, and the MoE layers' weights; an MoE model's
    # ``layers.w_gate_up`` / ``w_down`` stack its dense layers only.
    norms: Optional[BlockNorms] = None
    moe: Optional[MoEParams] = None

    def to(self, device) -> "ModelParams":
        def mv(t):
            return None if t is None else t.to(device)

        return ModelParams(
            embed=self.embed.to(device),
            layers=LayerParams(*(mv(t) for t in self.layers)),
            final_norm=self.final_norm.to(device),
            lm_head=self.lm_head.to(device),
            norms=None if self.norms is None else BlockNorms(
                *(t.to(device) for t in self.norms)),
            moe=mv(self.moe),
        )

    def layer(self, i: int) -> Block:
        """Layer ``i``'s weights (views of the stacked tensors)."""

        def at(t, j):
            return (None if t is None else t.layer(j)
                    if isinstance(t, QTensor) else t[j])

        lay, moe = self.layers, self.moe
        if moe is not None and i in moe.layers:
            mlp = dict(w_gate_up=None, w_down=None, moe=moe.layer(i))
        else:
            j = i - sum(m < i for m in moe.layers) if moe is not None else i
            mlp = dict(w_gate_up=at(lay.w_gate_up, j),
                       w_down=at(lay.w_down, j))
        norms = ({} if self.norms is None else
                 {f: t[i] for f, t in zip(BlockNorms._fields, self.norms)})
        return Block(attn_norm=at(lay.attn_norm, i), wqkv=at(lay.wqkv, i),
                     bqkv=at(lay.bqkv, i), wo=at(lay.wo, i),
                     mlp_norm=at(lay.mlp_norm, i), **mlp, **norms)

    @classmethod
    def from_tensors(cls, w: dict, model) -> "ModelParams":
        """An EXAONE 4 block model's (``ModelConfig.exaone4_block``) from
        flat tensors, no copy: ``embed``, ``final_norm``, ``lm_head``,
        ``wqkv`` and ``wo`` and the ``BlockNorms`` leaves [L, ...],
        ``dense_gate_up`` / ``dense_down`` over the dense layers [Ld, ...],
        and over the MoE layers ``router``, ``e_bias``, ``experts_gate_up``
        / ``experts_down`` of the held experts [Lm, Eh, ...],
        ``shared_gate_up`` / ``shared_down``."""
        moe = None
        if model.moe_layers:
            held = torch.tensor(model.held, dtype=torch.long,
                                device=w["router"].device)
            moe = MoEParams(w["router"], w["e_bias"], w["experts_gate_up"],
                            w["experts_down"], w["shared_gate_up"],
                            w["shared_down"], held, model.moe_layers)
        return cls(
            embed=w["embed"],
            layers=LayerParams(
                attn_norm=None, wqkv=w["wqkv"], bqkv=None, wo=w["wo"],
                mlp_norm=None, w_gate_up=w.get("dense_gate_up"),
                w_down=w.get("dense_down")),
            final_norm=w["final_norm"], lm_head=w["lm_head"],
            norms=BlockNorms(*(w[f] for f in BlockNorms._fields)), moe=moe)


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

"""Weight-only int8 quantization of the dense compute path (counterpart of
``shadowkv_tpu/core/wquant.py``).

Per-output-channel symmetric int8 weights halve the bytes of every weight
read and of the weights' device memory (an 8B model's 15 GiB of bf16
weights become 7.5 GiB). A ``QTensor`` pairs the int8 values with an f32
scale per output column; the matmul upcasts ``q`` to the activation dtype,
multiplies, then scales the OUTPUT columns: for a per-column scale s_j,
x @ (q * s) == (x @ q) * s. The product stays ``torch.matmul``, as the
JAX package leaves it to XLA outside any Pallas kernel; a fused int8-weight
GEMM is a later optimisation (ROADMAP.md §2).

The math is JAX's, bit for bit on the same f32 inputs, on the host and on
the card alike: amax over the contracted dim clamped at 1e-8, divided by
127 (a true division); round half to even, then clip to +-127.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QTensor(NamedTuple):
    """int8 weight + per-output-channel f32 scale.

    ``q`` keeps the original weight shape; ``s`` drops the contracted
    (input) dim: for a [in, out] weight it is [out], for stacked
    [L, in, out] it is [L, out], for a row-quantized [V, D] table [V].
    """

    q: torch.Tensor
    s: torch.Tensor

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.s.to(device))

    def layer(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked [L, ...] QTensor (views)."""
        return QTensor(self.q[i], self.s[i])


Weight = Union[torch.Tensor, QTensor]


def quantize_weight(w: torch.Tensor, reduce_axis: int = -2) -> QTensor:
    """Symmetric per-output-channel int8 quantization.

    ``reduce_axis`` is the contracted (input) dim that the scale
    collapses; the default -2 fits [.., in, out] matmul weights. Use
    ``reduce_axis=-1`` for row-quantized tables (embeddings)."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axis)
    # A tensor divisor: on CUDA, division by a Python scalar multiplies by
    # its reciprocal, which rounds differently from the host's division.
    s = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(wf / s.unsqueeze(reduce_axis))
    return QTensor(q=q.clamp(-127, 127).to(torch.int8), s=s)


def mat(x: torch.Tensor, w: Weight, out_dtype=None) -> torch.Tensor:
    """``x @ w`` for a plain or a QTensor weight. The product is taken in
    x's dtype; ``out_dtype`` (e.g. f32 for the lm_head) is the dtype of the
    result, to which a QTensor's output is cast before its scale."""
    if isinstance(w, QTensor):
        y = torch.matmul(x, w.q.to(x.dtype))
        if out_dtype is not None:
            y = y.to(out_dtype)
        return y * w.s.to(y.dtype)
    y = torch.matmul(x, w)
    return y if out_dtype is None else y.to(out_dtype)


def wslice(w: Weight, lo: int, hi: int) -> Weight:
    """Static slice of the OUTPUT dim (last axis of q / of a plain w)."""
    if isinstance(w, QTensor):
        return QTensor(q=w.q[..., lo:hi], s=w.s[..., lo:hi])
    return w[..., lo:hi]


def take_rows(table: Weight, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding lookup serving a plain [V, D] or a row-quantized QTensor
    table."""
    if isinstance(table, QTensor):
        rows = table.q[ids].to(dtype)
        return rows * table.s[ids].to(dtype)[..., None]
    return table[ids].to(dtype)


def quantize_params(params, quantize_embed: bool = True):
    """Quantize every matmul weight of a ``ModelParams`` to int8.

    Norm weights and biases stay in their float dtype (they are [D]
    vectors: no memory to win, and norms are precision-sensitive). The
    embedding table is row-quantized (per-token scale) unless
    ``quantize_embed=False``."""
    lay = params.layers
    return params._replace(
        embed=(quantize_weight(params.embed, reduce_axis=-1)
               if quantize_embed else params.embed),
        layers=lay._replace(
            wqkv=quantize_weight(lay.wqkv),
            wo=quantize_weight(lay.wo),
            w_gate_up=quantize_weight(lay.w_gate_up),
            w_down=quantize_weight(lay.w_down),
        ),
        lm_head=quantize_weight(params.lm_head),
    )

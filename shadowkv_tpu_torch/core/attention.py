"""Attention primitives (plain PyTorch).

Counterpart of ``shadowkv_tpu/core/attention.py``. These are the plain
versions: ``causal_prefill_attention`` and ``sparse_prefill_attention``
are also the references that the prefill kernels B and C
(``kernels/prefill_attention.py``, which take the place of the TPU splash
and flash library kernels) are held against, and the paths those kernels
take for CPU tensors. Decode attention over the compact or
full cache (``decode_attention_hm``) goes to ``kernels/decode_attention.py``,
whose plain version is the einsum math of JAX's function; the segmented
form (``decode_attention_segments``) stays tensor code.

Conventions: q is [B, S, H, Dh], k/v are [B, T, K, Dh] with GQA
(H = K * G, query head h = k*G + g reads KV head k). Softmax in fp32.
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.kernels.decode_attention import decode_attention

_F32_MIN = torch.finfo(torch.float32).min


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain (masked) GQA attention; mask broadcasts against [B,K,G,S,T]."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    g = h // kheads
    scale = scale if scale is not None else dh**-0.5
    qg = q.reshape(b, s, kheads, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgst,btkd->bskgd", probs.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, s, h, dh).to(q.dtype)


def causal_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    block_q: int = 512,
    offset: int | None = None,
) -> torch.Tensor:
    """Blockwise causal self-attention (query blocks of ``block_q`` keep the
    score temporaries at [B, H, block_q, T]). Query row i sits at key
    position ``offset + i``; by default q occupies the last S of the T key
    positions (``offset = T - S``). An explicit offset is the
    sequence-parallel form (JAX ``sp_causal_prefill_attention``): S local
    query rows at a global offset against all T >= offset + S keys."""
    return _blockwise(q, k, v, scale, block_q, None, 0, offset)


def sparse_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    sink: int,
    scale: float | None = None,
    block_q: int = 512,
) -> torch.Tensor:
    """Blockwise causal self-attention under the attention-sink + sliding
    window mask ``kv <= q & (kv < sink | q - kv < window)`` (the JAX
    ``SinkLocalMask`` of ``sparse_prefill_splash``)."""
    return _blockwise(q, k, v, scale, block_q, window, sink)


def _blockwise(q, k, v, scale, block_q, window, sink, offset=None):
    b, s, h, dh = q.shape
    t = k.shape[1]
    offset = t - s if offset is None else offset
    if offset < 0 or offset + s > t:
        raise ValueError(f"query rows [{offset}, {offset + s}) outside the "
                         f"{t} keys")
    pos_k = torch.arange(t, device=q.device)
    outs = []
    for q0 in range(0, s, block_q):
        qi = q[:, q0 : q0 + block_q]
        pos_q = offset + q0 + torch.arange(qi.shape[1], device=q.device)
        mask = pos_q[:, None] >= pos_k[None, :]
        if window is not None:
            mask &= (pos_k[None, :] < sink) \
                | (pos_q[:, None] - pos_k[None, :] < window)
        outs.append(mha(qi, k, v, mask=mask[None, None, None], scale=scale))
    return torch.cat(outs, dim=1)


def decode_attention_hm(
    q: torch.Tensor,
    k_hm: torch.Tensor,
    v_hm: torch.Tensor,
    kv_len: int | torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over a HEAD-MAJOR cache [B, K, T_cap, Dh].

    ``kv_len`` counts the valid rows including the S_new new tokens, which
    sit at rows [kv_len - S_new, kv_len) and are causal among themselves.
    It may be a 0-d device tensor, or a [B] one when every sequence sits at
    its own depth (continuous batching): the mask spans the whole
    ``T_cap``, so the shapes do not depend on it. CPU tensors take the
    plain version (``kernels/decode_attention.py::decode_attention_plain``),
    CUDA ones the decode-attention kernel.
    """
    return decode_attention(q, k_hm, v_hm, kv_len, scale)


def decode_attention_segments(
    q: torch.Tensor,
    segments,
    kv_len: int | torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over a SEGMENTED head-major cache (JAX
    ``decode_attention_segments``): the math of ``decode_attention_hm``
    over the concatenation of the segments without building it. Scores per
    segment, one f32 softmax over the concatenated score rows, and the sum
    of the per-segment P @ V products.

    ``segments``: (k_hm, v_hm, base, masked) with k/v [B, K, T_s, Dh] at
    absolute buffer rows [base, base + T_s); ``masked=False`` says every
    row is valid (the static prefix, the sparse region), ``masked=True``
    applies the ``kv_len`` validity mask (the gen region). ``kv_len`` is a
    0-d or [B] count of the valid rows including the S_new new tokens.
    """
    b, s_new, h, dh = q.shape
    kheads = segments[0][0].shape[1]
    g = h // kheads
    scale = scale if scale is not None else dh**-0.5
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.tensor(kv_len, device=q.device)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(b)
    qg = q.reshape(b, s_new, kheads, g, dh).float()
    q_abs = kv_len[:, None] - s_new + torch.arange(s_new, device=q.device)
    scores = []
    for k_hm, _, base, masked in segments:
        sc = torch.einsum("bskgd,bktd->bkgst", qg, k_hm.float()) * scale
        if masked:
            pos_k = base + torch.arange(k_hm.shape[2], device=q.device)
            mask = (pos_k <= q_abs[..., None])[:, None, None]  # [B,1,1,S,T]
            sc = torch.where(mask, sc, _F32_MIN)
        scores.append(sc)
    probs = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
    out = None
    off = 0
    for k_hm, v_hm, _, _ in segments:
        t = k_hm.shape[2]
        p = probs[..., off:off + t].to(v_hm.dtype).float()
        o = torch.einsum("bkgst,bktd->bskgd", p, v_hm.float())
        out = o if out is None else out + o
        off += t
    return out.reshape(b, s_new, h, dh).to(q.dtype)

"""Vertical + slash sparse prefill attention (kernel F).

Counterpart of ``shadowkv_tpu/kernels/vs_tile.py::vs_tile_attention`` (the
TPU kernel ``_vs_tile_kernel``), the default ``vs_impl="tile"`` execution of
``core/minference.py::minference_prefill_tile``:

    active(q, k) = causal & k < seq_len & (diag_flag[(q-k)//block] | k in v_idx)

with one online softmax per query row, each active pair counted once: the
diagonal phase skips vertical tokens, the vertical phase is masked by
causality only. The host side prepares what the TPU wrapper prepared in
XLA: duplicate verticals demoted to padding, the vertical K/V rows
gathered once per row, a per-token vertical flag and the vertical
positions. The CUDA kernel (``csrc/vs_tile.cu``) walks 64-key tiles and
reads the 128-granular diagonal flags itself, so the TPU's 512-wide
diagonal groups have no counterpart. Its plain version, taken for CPU
tensors, is ``vs_tok_attention_reference``.
"""

from __future__ import annotations

from typing import Optional

import torch

from shadowkv_tpu_torch.core.minference import masked_attention
from shadowkv_tpu_torch.kernels import build

TILE = 64  # key and query tile of the CUDA kernel


def vs_tok_attention_reference(
    q: torch.Tensor,  # [BH, S, Dh]
    k: torch.Tensor,  # [BKV, S, Dh]
    v: torch.Tensor,  # [BKV, S, Dh]
    v_idx: torch.Tensor,  # [BH, NV] vertical tokens (pad >= seq_len)
    diag_flag: torch.Tensor,  # [BH, nK] band flags
    kv_map: torch.Tensor,  # [BH]
    *,
    block: int = 128,
    scale: Optional[float] = None,
    seq_len: Optional[int] = None,
    block_q: int = 256,
) -> torch.Tensor:
    """Plain version of kernel F, blockwise over ``block_q`` queries (the
    JAX oracle holds [BH, S, S]). Returns [BH, S, Dh] in q's dtype; rows
    past ``seq_len`` are garbage."""
    bh, s, dh = q.shape
    seq_len = s if seq_len is None else seq_len
    scale = scale if scale is not None else dh**-0.5
    kv_map = kv_map.long()
    k_g, v_g = k.float()[kv_map], v[kv_map]
    outs = [masked_attention(q[:, q0:q0 + block_q], k_g, v_g, mask, scale)
            for q0, mask in tile_masks(v_idx, diag_flag, block, s, seq_len,
                                       block_q)]
    return torch.cat(outs, dim=1).to(q.dtype)


def tile_masks(v_idx, diag_flag, block: int, s: int, seq_len: int,
               block_q: int):
    """(q0, token mask [BH, block_q, S]) over the query blocks of kernel F's
    function: causal AND k < seq_len AND (band flag OR vertical token)."""
    nk = diag_flag.shape[1]
    vert = torch.zeros(v_idx.shape[0], s, dtype=torch.int32,
                       device=v_idx.device)
    vert.scatter_reduce_(1, v_idx.long().clamp(max=s - 1),
                         (v_idx < seq_len).to(torch.int32), reduce="amax")
    vert = vert > 0
    diag = diag_flag > 0
    pos = torch.arange(s, device=v_idx.device)
    for q0 in range(0, s, block_q):
        pq = pos[q0:q0 + block_q]
        band = torch.div(pq[:, None] - pos[None, :], block,
                         rounding_mode="floor").clamp(0, nk - 1)
        yield q0, ((pos[None, :] <= pq[:, None])
                   & (pos[None, :] < seq_len))[None] \
            & (diag[:, band] | vert[:, None, :])


def prepare_verticals(k, v, v_idx, kv_map, seq_len: int):
    """Host-side preparation of the kernel's vertical phase: each row's
    vertical tokens deduplicated (repeats demoted to the pad 2*S_pad) and
    sorted so that the pads come last, the NV list padded to a multiple
    of 64, the vertical K/V rows gathered [BH, NV, Dh], their positions
    [BH, NV] (pad where >= seq_len) and the per-token vertical flag
    [BH, S_pad] uint8 that the diagonal phase skips."""
    bh = v_idx.shape[0]
    s_pad = k.shape[1]
    pad = 2 * s_pad
    nv = -(-v_idx.shape[1] // TILE) * TILE
    srt = torch.sort(v_idx.to(torch.int32), dim=-1).values
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    pos = torch.where(dup | (srt >= seq_len), pad, srt)
    pos = torch.sort(pos, dim=-1).values
    pos = torch.nn.functional.pad(pos, (0, nv - pos.shape[1]), value=pad)
    idx = pos.long().clamp(max=s_pad - 1)
    rows = kv_map.long()[:, None]
    k_sel = k[rows, idx].contiguous()
    v_sel = v[rows, idx].contiguous()
    flag = torch.zeros(bh, s_pad + 1, dtype=torch.uint8, device=k.device)
    flag.scatter_(1, torch.where(pos < seq_len, pos, s_pad).long(), 1)
    return k_sel, v_sel, pos.contiguous(), flag[:, :s_pad].contiguous()


def vs_tile_attention(
    q: torch.Tensor,  # [BH, S_pad, Dh]
    k: torch.Tensor,  # [BKV, S_pad, Dh]
    v: torch.Tensor,  # [BKV, S_pad, Dh]
    v_idx: torch.Tensor,  # [BH, NV] vertical token indices (pad >= seq)
    diag_flag: torch.Tensor,  # [BH, nK] band flags (0/1)
    kv_map: torch.Tensor,  # [BH] int32
    *,
    block: int = 128,
    scale: float,
    seq_len: int,
) -> torch.Tensor:
    """Token-granular-vertical + band-granular-slash flash attention;
    returns [BH, S_pad, Dh] (rows past ``seq_len`` are garbage). The JAX
    wrapper's 512-row tiles (``tq``, ``tk``) have no counterpart: the CUDA
    kernel tiles by 64. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream or raise."""
    bh, s_pad, dh = q.shape
    if diag_flag.shape != (bh, -(-s_pad // block)):
        raise ValueError(f"diag_flag must be [BH, S_pad / block], got "
                         f"{tuple(diag_flag.shape)}")
    if not q.is_cuda:
        return vs_tok_attention_reference(q, k, v, v_idx, diag_flag, kv_map,
                                          block=block, scale=scale,
                                          seq_len=seq_len)
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("vs_tile_attention: q/k/v must be contiguous "
                             "bf16 CUDA tensors")
    if dh != 128 or k.shape[1:] != (s_pad, dh) or v.shape != k.shape:
        raise ValueError(f"kernel serves q [BH, S, 128], k/v [BKV, S, 128]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    if s_pad % TILE or not 0 < seq_len <= s_pad:
        raise ValueError(f"S_pad {s_pad} must be a multiple of {TILE} and "
                         "0 < seq_len <= S_pad")
    for t in (v_idx, diag_flag, kv_map):
        if not t.is_cuda:
            raise ValueError("vs_tile_attention: metadata must be on the card")
    if kv_map.shape != (bh,) or kv_map.dtype != torch.int32 \
            or v_idx.shape[0] != bh:
        raise ValueError("v_idx must be [BH, NV] and kv_map [BH] int32")
    k_sel, v_sel, vpos, vflag = prepare_verticals(k, v, v_idx, kv_map, seq_len)
    dflag = (diag_flag > 0).to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lib = build.library()
    vs_tile_attention.launches += 1
    rc = lib.shadowkv_vs_tile_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_sel.data_ptr(),
        v_sel.data_ptr(), vpos.data_ptr(), vflag.data_ptr(),
        dflag.data_ptr(), kv_map.contiguous().data_ptr(),
        out.data_ptr(), bh, k.shape[0], s_pad, vpos.shape[1],
        dflag.shape[1], block, seq_len, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "vs_tile_attention")
    return out


vs_tile_attention.launches = 0  # kernel launches (CUDA path only)

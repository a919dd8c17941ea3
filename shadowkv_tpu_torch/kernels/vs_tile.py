"""Vertical + slash sparse prefill attention (kernel F).

Counterpart of ``shadowkv_tpu/kernels/vs_tile.py::vs_tile_attention`` (the
TPU kernel ``_vs_tile_kernel``), the default ``vs_impl="tile"`` execution of
``core/minference.py::minference_prefill_tile``:

    active(q, k) = causal & k < seq_len & (diag_flag[(q-k)//block] | k in v_idx)

with one softmax per query row, each active pair counted once: the CUDA
kernel's diagonal phase counts the pairs whose band is on, its vertical
phase the vertical tokens whose band is off. The host side prepares what
the TPU wrapper prepared in XLA: duplicate verticals demoted to padding,
the vertical positions sorted and the vertical K/V rows gathered once per
row. The CUDA kernel (``csrc/vs_tile.cu``) walks 128-key tiles and reads
the block-granular band flags itself, so the TPU's 512-wide diagonal
groups have no counterpart; ``vs_tile_plan`` states which tiles it visits.
Its plain version, taken for CPU tensors, is ``vs_tok_attention_reference``.
A head_dim below 128 is zero-padded to 128 on the card and the output
sliced back (``build.pad_head_dim``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from shadowkv_tpu_torch.core.minference import masked_attention
from shadowkv_tpu_torch.kernels import build
# query rows of a block, keys of a tile and of a vertical tile
from shadowkv_tpu_torch.kernels.prefill_attention import TILE


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


def vertical_positions(v_idx, s_pad: int, seq_len: int) -> torch.Tensor:
    """Each row's vertical tokens as kernel F reads them, [BH, NV] int32:
    duplicates and entries at or past ``seq_len`` demoted to the pad
    ``2 * S_pad``, ascending so that the pads come last, NV padded to a
    multiple of TILE."""
    pad = 2 * s_pad
    nv = -(-v_idx.shape[1] // TILE) * TILE
    srt = torch.sort(v_idx.to(torch.int32), dim=-1).values
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    pos = torch.where(dup | (srt >= seq_len), pad, srt)
    pos = torch.sort(pos, dim=-1).values
    pos = torch.nn.functional.pad(pos, (0, nv - pos.shape[1]), value=pad)
    return pos.contiguous()


def prepare_verticals(k, v, v_idx, kv_map, seq_len: int):
    """Host-side preparation of the kernel's vertical phase: the positions
    of ``vertical_positions`` and the vertical K/V rows they name, gathered
    [BH, NV, Dh] (pads read the last row; the kernel masks them)."""
    s_pad = k.shape[1]
    pos = vertical_positions(v_idx, s_pad, seq_len)
    idx = pos.long().clamp(max=s_pad - 1)
    rows = kv_map.long()[:, None]
    return k[rows, idx].contiguous(), v[rows, idx].contiguous(), pos


class VsTilePlan(NamedTuple):
    """Kernel F's tiles for every (row, 128-row query block): ``full`` and
    ``masked`` [BH, nQ, nT] mark the visited key tiles of the diagonal
    phase (full ones hold only pairs whose band is on and take no per-pair
    test), ``vertical`` [BH, nQ, NV / TILE] the visited tiles of the
    vertical list (always masked). The rest are skipped."""

    full: torch.Tensor
    masked: torch.Tensor
    vertical: torch.Tensor


def _bands_on(diag_flag, lo, hi):
    """How many bands of [lo, hi] (inclusive) are on: lo and hi are long
    tensors of 3 dimensions that broadcast to [BH, n, m]."""
    cs = torch.nn.functional.pad(torch.cumsum((diag_flag > 0).int(), -1),
                                 (1, 0))
    lo, hi = torch.broadcast_tensors(lo, hi)
    shape = (cs.shape[0],) + lo.shape[1:]
    lo, hi = (x.expand(shape).reshape(shape[0], -1) for x in (lo, hi))
    return (cs.gather(1, hi + 1) - cs.gather(1, lo)).reshape(shape)


def vs_tile_plan(vpos, diag_flag, block: int, s_pad: int,
                 seq_len: int) -> VsTilePlan:
    """The tiles kernel F visits (``csrc/vs_tile.cu``'s ``BandPlan``
    transcribes this function). For the query block of rows [q0, q1] (q1
    the last row below ``seq_len``; blocks at or past it visit nothing):

    - diagonal phase: key tile t (keys [k0, k1]) with k0 <= q1 is visited
      iff a band of [max(0, q0 - k1) // block, (q1 - k0) // block] is on,
      and full iff every one is, k1 <= q0 and k1 < seq_len;
    - vertical phase: tile j of ``vpos`` (``vertical_positions``) is
      visited iff its first position v_lo <= q1 and some band of
      [max(0, q0 - v_hi) // block, (q1 - v_lo) // block] is off, v_hi its
      last position capped at q1.

    Its pairs count in the diagonal phase iff causal, below ``seq_len`` and
    their band is on, in the vertical phase iff causal, below ``seq_len``
    and their band is off."""
    nk = diag_flag.shape[1]
    dev = diag_flag.device
    nq = -(-s_pad // TILE)
    q0 = torch.arange(nq, device=dev) * TILE
    q1 = (q0 + TILE).clamp(max=seq_len) - 1
    live = (q0 < seq_len)[:, None]
    k0 = q0[None, :]
    k1 = k0 + TILE - 1
    lo = ((q0[:, None] - k1).clamp(min=0) // block)[None]
    hi = (((q1[:, None] - k0).clamp(min=0) // block).clamp(max=nk - 1))[None]
    n_on = _bands_on(diag_flag, lo, hi)
    visit = live & (k0 <= q1[:, None]) & (n_on > 0)
    full = visit & (n_on == hi - lo + 1) & (k1 <= q0[:, None]) \
        & (k1 < seq_len)
    v_lo = vpos[:, ::TILE].long()[:, None, :]  # [BH, 1, nV]
    v_hi = torch.minimum(vpos[:, TILE - 1::TILE].long()[:, None, :],
                         q1[None, :, None])
    lo = (q0[None, :, None] - v_hi).clamp(min=0) // block
    hi = ((q1[None, :, None] - v_lo).clamp(min=0) // block).clamp(
        max=nk - 1)
    vertical = live & (v_lo <= q1[None, :, None]) \
        & (_bands_on(diag_flag, lo, hi) < hi - lo + 1)
    return VsTilePlan(full=full, masked=visit & ~full, vertical=vertical)


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
    kernel tiles by 128 (``vs_tile_plan``). CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream or
    raise."""
    bh, s_pad, dh = q.shape
    if diag_flag.shape != (bh, -(-s_pad // block)):
        raise ValueError(f"diag_flag must be [BH, S_pad / block], got "
                         f"{tuple(diag_flag.shape)}")
    if not q.is_cuda:
        return vs_tok_attention_reference(q, k, v, v_idx, diag_flag, kv_map,
                                          block=block, scale=scale,
                                          seq_len=seq_len)
    q, k, v = build.check_rows(q, k, v, "vs_tile_attention")
    if s_pad % 64 or not 0 < seq_len <= s_pad:
        raise ValueError(f"S_pad {s_pad} must be a multiple of 64 and "
                         "0 < seq_len <= S_pad")
    for t in (v_idx, diag_flag, kv_map):
        if not t.is_cuda:
            raise ValueError("vs_tile_attention: metadata must be on the card")
    if kv_map.shape != (bh,) or kv_map.dtype != torch.int32 \
            or v_idx.shape[0] != bh:
        raise ValueError("v_idx must be [BH, NV] and kv_map [BH] int32")
    k_sel, v_sel, vpos = prepare_verticals(k, v, v_idx, kv_map, seq_len)
    dflag = (diag_flag > 0).to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lib = build.library()
    vs_tile_attention.launches += 1
    rc = lib.shadowkv_vs_tile_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_sel.data_ptr(),
        v_sel.data_ptr(), vpos.data_ptr(), dflag.data_ptr(),
        kv_map.contiguous().data_ptr(), out.data_ptr(), bh, k.shape[0],
        s_pad, vpos.shape[1], dflag.shape[1], block, seq_len, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "vs_tile_attention")
    return build.unpad_head_dim(out, dh)


vs_tile_attention.launches = 0  # kernel launches (CUDA path only)

"""Causal GQA prefill attention: dense (kernel B) and sink + window (C).

Takes the place of the TPU library kernels that
``shadowkv_tpu/core/attention.py`` reaches: ``causal_prefill_splash``
(splash MQA, K/V consumed per GQA group) and ``causal_prefill_flash``
(flash attention, K/V repeated to H heads) compute the same function, so
both names route to kernel B; ``sparse_prefill_splash`` (splash MQA under
the sink + sliding-window mask) is kernel C, the same Hopper kernel
(``csrc/prefill_attention.cu``) given a window and a sink, which skips
every key tile outside both. It reads KV head ``h // G`` for query head
``h`` without repeating K/V. Their plain versions, taken for CPU
tensors, are ``core/attention.py::causal_prefill_attention`` and
``sparse_prefill_attention``; each wrapper counts its own launches.

The kernel computes in head_dim 128. A smaller head_dim (Phi-3's 96) is
zero-padded to 128 on the card and the output sliced back
(``build.pad_head_dim``); the softmax scale stays that of the true head_dim.

``prefill_tile_plan`` states in Python which key tiles the kernel visits
for each query block and which of them need a per-pair mask; the CUDA
kernel transcribes it (``TilePlan``) and the CPU tests hold it against the
dense mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadowkv_tpu_torch.core.attention import (
    causal_prefill_attention,
    sparse_prefill_attention,
)
from shadowkv_tpu_torch.kernels import build


def _check(q, k, v):
    """q/k/v as the kernel reads them through TMA; returns them zero-padded
    from head_dim Dh <= 128 to 128 (``build.pad_head_dim``)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("prefill attention kernel: q/k/v must be "
                             "contiguous bf16 CUDA tensors")
    if k.shape != (b, s, kh, dh) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, S, K, Dh] matching q {tuple(q.shape)}")
    if h % kh != 0:
        raise ValueError(f"kernel serves H % K == 0 (got H {h}, K {kh})")
    q, k, v = build.pad_head_dim((q, k, v), "prefill attention kernel")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("prefill attention kernel: q/k/v must start on a "
                         "16-byte boundary (TMA)")
    return q, k, v


TILE = 128  # query rows of a block and keys of a tile (B, C, F and G)


class TilePlan(NamedTuple):
    """The key tiles of one query block: ``full`` tiles hold only active
    (query, key) pairs and take no per-pair test, ``masked`` tiles hold
    some, ``skipped`` tiles none."""

    full: list[int]
    masked: list[int]
    skipped: list[int]


def prefill_tile_plan(seq: int, window: int | None = None,
                      sink: int = 0) -> list[TilePlan]:
    """Per query block (rows ``[i * TILE, (i + 1) * TILE)``), the key tiles
    (keys ``[t * TILE, (t + 1) * TILE)``) that B (``window=None``: causal) or
    C (key kv visible to query q iff ``kv <= q`` and ``kv < sink`` or
    ``q - kv < window``) visits. Visited are the sink tiles ``[0,
    n_sink)`` and the tiles ``[first_win, last]`` that hold a key inside
    the window of some row; a visited tile is full when every key lies at
    or below the block's first row and is a sink key or inside the window
    of the block's last row. ``csrc/prefill_attention.cu``'s ``TilePlan``
    is this function in CUDA."""
    window = seq if window is None else max(0, min(window, seq))
    sink = max(0, min(sink, seq))
    n_tiles = -(-seq // TILE)
    plans = []
    for q0 in range(0, seq, TILE):
        q1 = min(q0 + TILE, seq) - 1
        last = q1 // TILE
        n_sink = min(last + 1, -(-sink // TILE))
        first_win = last + 1
        if window > 0:
            x = q0 - window - (TILE - 2)
            first_win = max(n_sink, 0 if x <= 0 else -(-x // TILE))
        visit = list(range(n_sink)) + list(range(first_win, last + 1))
        full = [t for t in visit
                if (t + 1) * TILE - 1 <= q0
                and ((t + 1) * TILE - 1 < sink
                     or q1 - max(t * TILE, sink) < window)]
        plans.append(TilePlan(
            full=full,
            masked=[t for t in visit if t not in full],
            skipped=[t for t in range(n_tiles) if t not in visit],
        ))
    return plans


def causal_prefill_splash(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, K, Dh]
    v: torch.Tensor,  # [B, S, K, Dh]
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA self-attention over a whole prompt, softmax scale
    ``Dh**-0.5`` unless given. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream or raise."""
    b, s, h, dh = q.shape
    scale = scale if scale is not None else dh**-0.5
    if not q.is_cuda:
        return causal_prefill_attention(q, k, v, scale=scale)
    q, k, v = _check(q, k, v)
    out = torch.empty_like(q)
    lib = build.library()
    causal_prefill_splash.launches += 1
    rc = lib.shadowkv_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], build.HEAD_DIM, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "prefill attention")
    return build.unpad_head_dim(out, dh)


def sparse_prefill_splash(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, K, Dh]
    v: torch.Tensor,  # [B, S, K, Dh]
    window: int,
    sink: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA self-attention under ``kv < sink | q - kv < window``
    (attention sink + sliding window). CPU tensors take the plain version;
    CUDA tensors launch kernel C on the current stream or raise."""
    b, s, h, dh = q.shape
    scale = scale if scale is not None else dh**-0.5
    if not q.is_cuda:
        return sparse_prefill_attention(q, k, v, window, sink, scale=scale)
    q, k, v = _check(q, k, v)
    out = torch.empty_like(q)
    lib = build.library()
    sparse_prefill_splash.launches += 1
    # Beyond the sequence a larger window or sink changes nothing.
    rc = lib.shadowkv_sparse_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], build.HEAD_DIM, float(scale),
        max(0, min(int(window), s)), max(0, min(int(sink), s)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "sparse prefill attention")
    return build.unpad_head_dim(out, dh)


sparse_prefill_splash.launches = 0  # kernel launches (CUDA path only)


causal_prefill_splash.launches = 0  # kernel launches (CUDA path only)

# The flash variant repeated K/V to H heads for the TPU library kernel; the
# function is the same, so it is the same kernel here.
causal_prefill_flash = causal_prefill_splash

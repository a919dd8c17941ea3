"""Block-sparse flash attention over vertical/slash block metadata (kernel G).

Counterpart of ``shadowkv_tpu/kernels/vs_sparse.py::vs_sparse_attention``
(the TPU kernel ``_vs_kernel``), the ``vs_impl="walk"`` execution of
``core/minference.py::minference_prefill``. For each (row, query block) it
visits only the key tiles of the active blocks

    active[qb, kb] = causal & (col_flag[kb] | diag_flag[qb - kb])

with one softmax and token causality, each active pair counted once. The
CUDA kernel is ``csrc/vs_sparse.cu``; ``vs_walk_plan`` states which
128-key tiles it visits. Its plain version, taken for CPU tensors, is
``core/minference.py::vs_attention_reference``. One launch covers every
``B*H`` row (the TPU's per-batch launch loop was an SMEM limit).
A head_dim below 128 is zero-padded to 128 on the card and the output
sliced back (``build.pad_head_dim``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadowkv_tpu_torch.core.minference import VSMeta, vs_attention_reference
from shadowkv_tpu_torch.kernels import build
from shadowkv_tpu_torch.kernels.prefill_attention import TILE


class WalkPlan(NamedTuple):
    """Kernel G's key tiles for every (row, 128-row query block), [BH, nQ,
    nT] each: ``full`` tiles hold only active pairs and take no per-pair
    test, ``masked`` ones some; the rest are skipped."""

    full: torch.Tensor
    masked: torch.Tensor


def vs_walk_plan(col_flag, diag_flag, block: int, s_pad: int,
                 seq_len: int) -> WalkPlan:
    """The tiles kernel G visits (``csrc/vs_sparse.cu``'s ``BlockPlan``
    transcribes this function), from [BH, S_pad / block] column and
    diagonal flags. For the query block of rows [q0, q1] (q1 the last row
    below ``seq_len``; blocks at or past it visit nothing), key tile t
    (keys [k0, k1], k0 <= q1) overlaps query blocks q0 // block .. q1 //
    block and key blocks k0 // block .. min(k1, S_pad - 1) // block (two
    of each at most, as block is a multiple of 64). It is visited iff one
    of those (qb, kb) pairs is active and holds a causal pair (its first
    key at or below its last row), and full iff every one is active, k1 <=
    q0 and k1 < seq_len."""
    n_blk = s_pad // block
    dev = col_flag.device
    col = col_flag > 0
    dg = diag_flag > 0
    nq = -(-s_pad // TILE)
    q0 = torch.arange(nq, device=dev)[:, None] * TILE  # [nQ, 1]
    q1 = (q0 + TILE).clamp(max=seq_len) - 1
    k0 = q0.T  # [1, nT]
    k1 = k0 + TILE - 1
    visit = torch.zeros(col.shape[0], nq, nq, dtype=torch.bool, device=dev)
    every = torch.ones_like(visit)
    for qb in (q0 // block, q1.clamp(min=0) // block):
        for kb in (k0 // block, k1.clamp(max=s_pad - 1) // block):
            act = (kb <= qb) & (col[:, kb.clamp(max=n_blk - 1)]
                                | dg[:, (qb - kb).clamp(0, n_blk - 1)])
            causal = torch.maximum(k0, kb * block) \
                <= torch.minimum(q1, qb * block + block - 1)
            visit |= act & causal
            every &= act
    visit &= (q0 < seq_len) & (k0 <= q1)
    full = visit & every & (k1 <= q0) & (k1 < seq_len)
    return WalkPlan(full=full, masked=visit & ~full)


def vs_sparse_attention(
    q: torch.Tensor,  # [BH, S_pad, Dh]
    k: torch.Tensor,  # [BKV, S_pad, Dh]
    v: torch.Tensor,  # [BKV, S_pad, Dh]
    col_ids: torch.Tensor,  # [BH, nK] int32
    col_cnt: torch.Tensor,  # [BH, nQ] int32
    col_flag: torch.Tensor,  # [BH, nK] int32
    diag_ids: torch.Tensor,  # [BH, nQ] int32
    diag_cnt: torch.Tensor,  # [BH, nQ] int32
    kv_map: torch.Tensor,  # [BH] int32
    *,
    block: int,
    scale: float,
    seq_len: int,
) -> torch.Tensor:
    """Flash attention over the runtime block mask; returns [BH, S_pad, Dh]
    (rows past ``seq_len`` are garbage). CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream or raise. The
    kernel reads the flags (``col_flag``, and ``diag_ids`` up to the last
    ``diag_cnt``); the column lists stay in the signature for JAX parity."""
    bh, s_pad, dh = q.shape
    meta = VSMeta(col_ids, col_cnt, col_flag, diag_ids, diag_cnt)
    if not q.is_cuda:
        return vs_attention_reference(q, k, v, meta, kv_map, block,
                                      scale=scale, seq_len=seq_len)
    q, k, v = build.check_rows(q, k, v, "vs_sparse_attention")
    if block % 64 or s_pad % block or not 0 < seq_len <= s_pad:
        raise ValueError(f"block {block} must be a multiple of 64 dividing "
                         f"S_pad {s_pad}, and 0 < seq_len <= S_pad")
    n_blk = s_pad // block
    for t in (col_ids, col_cnt, col_flag, diag_ids, diag_cnt, kv_map):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("vs_sparse_attention: metadata must be "
                             "contiguous int32 CUDA tensors")
    if any(t.shape != (bh, n_blk) for t in (col_ids, col_cnt, col_flag,
                                            diag_ids, diag_cnt)) \
            or kv_map.shape != (bh,):
        raise ValueError("metadata must be [BH, S_pad / block], kv_map [BH]")
    out = torch.empty_like(q)
    lib = build.library()
    vs_sparse_attention.launches += 1
    rc = lib.shadowkv_vs_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), col_flag.data_ptr(),
        diag_ids.data_ptr(), diag_cnt.data_ptr(), kv_map.data_ptr(),
        out.data_ptr(), bh, k.shape[0], s_pad, block, seq_len, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "vs_sparse_attention")
    return build.unpad_head_dim(out, dh)


vs_sparse_attention.launches = 0  # kernel launches (CUDA path only)

"""Block-sparse flash attention over vertical/slash block metadata (kernel G).

Counterpart of ``shadowkv_tpu/kernels/vs_sparse.py::vs_sparse_attention``
(the TPU kernel ``_vs_kernel``), the ``vs_impl="walk"`` execution of
``core/minference.py::minference_prefill``. For each (row, query block) it
visits only the active key blocks

    active[qb, kb] = causal & (col_flag[kb] | diag_flag[qb - kb])

first the column blocks ``col_ids[:col_cnt[qb]]``, then the diagonal
blocks ``qb - diag_ids[:diag_cnt[qb]]`` that are not also columns, with
one online softmax and token causality. The CUDA kernel is
``csrc/vs_sparse.cu``; its plain version, taken for CPU tensors, is
``core/minference.py::vs_attention_reference``. One launch covers every
``B*H`` row (the TPU's per-batch launch loop was an SMEM limit).
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.core.minference import VSMeta, vs_attention_reference
from shadowkv_tpu_torch.kernels import build


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
    CUDA tensors launch the kernel on the current stream or raise."""
    bh, s_pad, dh = q.shape
    meta = VSMeta(col_ids, col_cnt, col_flag, diag_ids, diag_cnt)
    if not q.is_cuda:
        return vs_attention_reference(q, k, v, meta, kv_map, block,
                                      scale=scale, seq_len=seq_len)
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("vs_sparse_attention: q/k/v must be contiguous "
                             "bf16 CUDA tensors")
    if dh != 128 or k.shape[1:] != (s_pad, dh) or v.shape != k.shape:
        raise ValueError(f"kernel serves q [BH, S, 128], k/v [BKV, S, 128]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
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
        q.data_ptr(), k.data_ptr(), v.data_ptr(), col_ids.data_ptr(),
        col_cnt.data_ptr(), col_flag.data_ptr(), diag_ids.data_ptr(),
        diag_cnt.data_ptr(), kv_map.data_ptr(), out.data_ptr(),
        bh, k.shape[0], s_pad, block, seq_len, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "vs_sparse_attention")
    return out


vs_sparse_attention.launches = 0  # kernel launches (CUDA path only)

"""Fused sparse-buffer refresh (kernel A): the ShadowKV decode hot path.

Counterpart of ``shadowkv_tpu/kernels/reconstruct.py::sparse_refresh``
(the TPU kernel ``_refresh_kernel``). For one layer and every (batch, kv
head) it walks the compacted miss list and, for each missed chunk ``cid``
placed in sparse slot ``s``:

- rebuilds K rows ``(U[cid rows] @ SV[b, k]) * u_scale`` with f32
  accumulation, rotates them at positions ``cid*cs + i`` (f32 angles
  ``pos * inv_freq_full``, neox rotate-half or glm interleaved pairs over
  ``rope_dim`` lanes) and writes them to ``k_buf[.., sparse_start + s*cs]``;
- writes the chunk's V rows to ``v_buf``; int8 rows are dequantized as
  ``int8 * bf16 scale`` (exact in f32) and rounded once to the buffer dtype,
  which for bf16 buffers is the TPU kernel's bf16 multiply.

Hit slots move no bytes. The JAX kernel returns new buffers aliased onto
its inputs (``input_output_aliases``); here ``k_buf``/``v_buf`` are
updated IN PLACE and returned.

``v_full`` may be a PINNED CPU tensor (``mode="shadow_offload"``; the TPU
kernel's ``host_v`` variant): the CUDA kernel then reads the missed chunks'
V rows in place over the host link. Every other operand, the V scales
included, lies on the card. CPU miss lists take the plain version; CUDA
ones launch the kernel or raise.

Store layout (the port's own; see ``core/quant.py``): U is
``[L, B, C*cs, rank]`` (no TPU lane padding), V is ``[L, B, K, C*cs, Dh]``;
int8 stores carry their bf16 per-token scales in separate tensors
``u_scale [L, B, C*cs]`` and ``v_scale [L, B, K, C*cs]``.

INVARIANT (same as the TPU kernel): each (b, k)'s ``miss_chunk[:miss_cnt]``
is sorted ascending without duplicates (``core/selection.py::compact_misses``
over ``assign_slots_stable`` output guarantees it) and every id is a valid
chunk; the CUDA kernel does not bounds-check device-side ids.
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.kernels import build

_NEOX, _GLM = "neox", "glm"


def sparse_refresh_plain(
    layer: int,
    miss_chunk: torch.Tensor,
    miss_slot: torch.Tensor,
    miss_cnt: torch.Tensor,
    u: torch.Tensor,
    sv: torch.Tensor,
    v_full: torch.Tensor,
    inv_freq_full: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    *,
    chunk_size: int,
    sparse_start: int,
    rope_dim: int,
    rope_style: str = _NEOX,
    u_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the refresh (same arithmetic as the kernel)."""
    cs = chunk_size
    s = miss_chunk.shape[-1]
    dev = miss_chunk.device
    valid = torch.arange(s, device=dev) < miss_cnt[..., None].long()
    bi, ki, ji = valid.nonzero(as_tuple=True)
    if bi.numel() == 0:
        return k_buf, v_buf
    off = torch.arange(cs, device=dev)
    cid = miss_chunk[bi, ki, ji].long()
    slot = miss_slot[bi, ki, ji].long()
    rows = cid[:, None] * cs + off  # [M, cs] store rows
    dst = sparse_start + slot[:, None] * cs + off  # [M, cs] buffer rows
    b2, k2 = bi[:, None], ki[:, None]
    quant = u.dtype == torch.int8

    u_rows = u[layer][b2, rows]  # [M, cs, r]
    if quant:
        u_rows = u_rows.to(torch.bfloat16)
    k_rec = torch.matmul(u_rows.float(), sv[layer][bi, ki].float())
    if quant:
        k_rec = k_rec * u_scale[layer][b2, rows].float()[..., None]
    dh = k_rec.shape[-1]
    lane = torch.arange(dh, device=dev)
    ang = rows.float()[..., None] * inv_freq_full.reshape(dh).float()
    if rope_style == _NEOX:
        partner = torch.roll(k_rec, rope_dim // 2, dims=-1)
        sign = torch.where(lane < rope_dim // 2, -1.0, 1.0)
    elif rope_style == _GLM:
        partner = torch.where(
            lane % 2 == 0,
            torch.roll(k_rec, -1, dims=-1),
            torch.roll(k_rec, 1, dims=-1),
        )
        sign = torch.where(lane % 2 == 0, -1.0, 1.0)
    else:
        raise ValueError(f"unknown rope style: {rope_style}")
    roped = k_rec * torch.cos(ang) + partner * sign * torch.sin(ang)
    k_new = torch.where(lane < rope_dim, roped, k_rec)
    k_buf[layer][b2, k2, dst] = k_new.to(k_buf.dtype)

    v_rows = v_full[layer][b2, k2, rows]  # [M, cs, Dh]
    if quant:
        # int8 x bf16 is exact in f32; one rounding to the buffer dtype.
        v_rows = v_rows.float() * v_scale[layer][b2, k2, rows].float()[..., None]
    v_buf[layer][b2, k2, dst] = v_rows.to(v_buf.dtype)
    return k_buf, v_buf


def _check_cuda_args(miss_chunk, miss_slot, miss_cnt, u, sv, v_full,
                     inv_freq_full, k_buf, v_buf, u_scale, v_scale,
                     chunk_size, rope_dim, rope_style):
    l, b, n_rows, rank = u.shape
    kh, dh = sv.shape[2], sv.shape[4]
    quant = u.dtype == torch.int8
    tensors = [miss_chunk, miss_slot, miss_cnt, u, sv, inv_freq_full,
               k_buf, v_buf]
    if quant:
        tensors += [u_scale, v_scale]
    for t in tensors:
        if t is None or not t.is_cuda or not t.is_contiguous():
            raise ValueError("sparse_refresh: every operand but v_full must "
                             "be a contiguous CUDA tensor")
        if t.device != miss_chunk.device:
            raise ValueError("sparse_refresh: operands on different devices")
    build.check_v_store(v_full, miss_chunk.device, "sparse_refresh")
    if dh != 128:
        raise ValueError(f"sparse_refresh kernel serves head_dim 128, got {dh}")
    if rank * u.element_size() % 4:
        raise ValueError(f"sparse_refresh kernel: a U row of rank {rank} "
                         "must be a multiple of 4 bytes")
    if sv.dtype != torch.bfloat16 or k_buf.dtype != torch.bfloat16 \
            or v_buf.dtype != torch.bfloat16:
        raise ValueError("sparse_refresh kernel needs bf16 sv/k_buf/v_buf")
    if quant:
        if v_full.dtype != torch.int8:
            raise ValueError("int8 U needs an int8 V store")
        for t in (u_scale, v_scale):
            if t.dtype != torch.bfloat16:
                raise ValueError("int8 store scales must be bf16")
        if u_scale.shape != (l, b, n_rows) or v_scale.shape != (l, b, kh, n_rows):
            raise ValueError("store scale shapes do not match the stores")
    elif u.dtype != torch.bfloat16 or v_full.dtype != torch.bfloat16:
        raise ValueError("unquantized stores must be bf16")
    if sv.shape != (l, b, kh, rank, dh) or v_full.shape != (l, b, kh, n_rows, dh):
        raise ValueError(f"store shapes disagree: u {tuple(u.shape)}, sv "
                         f"{tuple(sv.shape)}, v {tuple(v_full.shape)}")
    if k_buf.shape != v_buf.shape or k_buf.shape[:3] != (l, b, kh) \
            or k_buf.shape[4] != dh:
        raise ValueError("k_buf/v_buf must be [L, B, K, cap, Dh]")
    for t in (miss_chunk, miss_slot, miss_cnt):
        if t.dtype != torch.int32:
            raise ValueError("miss lists must be int32")
    if miss_chunk.shape[:2] != (b, kh) or miss_slot.shape != miss_chunk.shape \
            or miss_cnt.shape != (b, kh):
        raise ValueError("miss lists must be [B, K, S] / [B, K]")
    if inv_freq_full.dtype != torch.float32 or inv_freq_full.numel() != dh:
        raise ValueError("inv_freq_full must be f32 with head_dim entries")
    if rope_style not in (_NEOX, _GLM):
        raise ValueError(f"unknown rope style: {rope_style}")
    if rope_style == _NEOX and rope_dim != dh:
        raise ValueError("neox RoPE rotates the whole head")


def sparse_refresh(
    layer: int,
    miss_chunk: torch.Tensor,  # [B, K, S] int32 compacted miss chunk ids
    miss_slot: torch.Tensor,  # [B, K, S] int32 slot of each miss
    miss_cnt: torch.Tensor,  # [B, K] int32
    u: torch.Tensor,  # [L, B, C*cs, r] int8 | model dtype
    sv: torch.Tensor,  # [L, B, K, r, Dh]
    v_full: torch.Tensor,  # [L, B, K, C*cs, Dh]; CUDA or pinned CPU
    inv_freq_full: torch.Tensor,  # [Dh] f32 per-lane inverse frequencies
    k_buf: torch.Tensor,  # [L, B, K, cap, Dh], updated in place
    v_buf: torch.Tensor,  # [L, B, K, cap, Dh], updated in place
    *,
    chunk_size: int,
    sparse_start: int,
    rope_dim: int,
    rope_style: str = _NEOX,
    u_scale: torch.Tensor | None = None,  # [L, B, C*cs] bf16 (int8 stores)
    v_scale: torch.Tensor | None = None,  # [L, B, K, C*cs] bf16 (int8 stores)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Refresh layer ``layer``'s sparse region of k_buf/v_buf in place.

    CPU miss lists take the plain version; CUDA ones launch the kernel
    (``csrc/refresh.cu``) on the current stream or raise.

    Precondition of the kernel: the two lanes of a rotated pair share one
    frequency (``inv_freq_full[c] == inv_freq_full[c + rope_dim // 2]`` for
    neox, ``inv_freq_full[c] == inv_freq_full[c ^ 1]`` for glm), as
    ``core/rope.py::inv_freq_full_neox`` builds it: the kernel computes one
    angle per pair. The kernel serves head_dim 128 and U rows of a multiple
    of 4 bytes: an even rank for bf16 stores, a multiple of 4 for int8.
    """
    kw = dict(chunk_size=chunk_size, sparse_start=sparse_start,
              rope_dim=rope_dim, rope_style=rope_style,
              u_scale=u_scale, v_scale=v_scale)
    if not miss_chunk.is_cuda:
        return sparse_refresh_plain(
            layer, miss_chunk, miss_slot, miss_cnt, u, sv, v_full,
            inv_freq_full, k_buf, v_buf, **kw,
        )
    _check_cuda_args(miss_chunk, miss_slot, miss_cnt, u, sv, v_full,
                     inv_freq_full, k_buf, v_buf, u_scale, v_scale,
                     chunk_size, rope_dim, rope_style)
    l, b, n_rows, rank = u.shape
    kh, dh = sv.shape[2], sv.shape[4]
    if not 0 <= layer < l:
        raise IndexError(f"layer {layer} out of range for {l} layers")
    cap = k_buf.shape[3]
    select_sets = miss_chunk.shape[-1]
    if sparse_start + select_sets * chunk_size > cap:
        raise ValueError("sparse region exceeds the buffer capacity")
    quant = u.dtype == torch.int8
    lib = build.library()
    smem = lib.shadowkv_sparse_refresh_smem_bytes(rank, int(quant))
    if smem > 232448:
        raise ValueError(f"rank {rank} needs {smem} B of shared memory")
    sparse_refresh.launches += 1
    if not v_full.is_cuda:
        sparse_refresh.host_launches += 1
    rc = lib.shadowkv_sparse_refresh(
        u[layer].data_ptr(),
        u_scale[layer].data_ptr() if quant else None,
        sv[layer].data_ptr(),
        v_full[layer].data_ptr(),
        v_scale[layer].data_ptr() if quant else None,
        inv_freq_full.data_ptr(),
        miss_chunk.data_ptr(), miss_slot.data_ptr(), miss_cnt.data_ptr(),
        k_buf[layer].data_ptr(), v_buf[layer].data_ptr(),
        b, kh, n_rows, rank, dh, select_sets, cap, chunk_size,
        sparse_start, rope_dim, int(rope_style == _GLM), int(quant),
        torch.cuda.current_stream(miss_chunk.device).cuda_stream,
    )
    build.check(rc, "sparse_refresh")
    return k_buf, v_buf


sparse_refresh.launches = 0  # kernel launches (CUDA path only)
sparse_refresh.host_launches = 0  # of which read V from pinned host memory

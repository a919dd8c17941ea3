"""Chunk gather (kernel D) for the XLA-gather decode branch.

Counterpart of ``shadowkv_tpu/kernels/gather.py::gather_chunks`` (the TPU
kernels ``_gather_kernel`` for stores in device memory, and
``_u_gather_kernel`` + ``_v_host_kernel`` for a V store in pinned host
memory). For one layer it fetches the rows of EVERY selected chunk (hits
too) from the U and V stores, token-major:

    u_tok [B, K, S*cs, r]   (U is shared by the KV heads; fetched per head)
    v_tok [B, K, S*cs, Dh]
    u_sc  [B, K, S*cs]      bf16 U scales of those rows (int8 stores)
    v_sc  [B, K, S*cs]      bf16 V scales of those rows (int8 stores)

Dequantization, the U x SV product and RoPE stay in tensor code
(``cache/shadow.py``), as in the JAX package. The JAX package folds the
int8 scales into U's tail lanes, so its kernel moves them with the rows;
the port keeps them in their own tensors and the kernel gathers them too.

``v_full`` may be a CUDA tensor or a PINNED CPU tensor: one CUDA kernel
(``csrc/gather.cu``) reads either in place. CPU ids take the plain version
(tensor indexing); CUDA ids launch the kernel or raise.

The ids come from ``assign_slots_stable``, so every id is a valid chunk;
the kernel does not bounds-check them.

``gather_v_rows`` is the port's own kernel for the JAX ``HostVStore`` path
(``shadowkv_tpu/cache/offload.py``), which has no Pallas kernel: V rows
only, of the
chunks that missed (a slot whose chunk stayed is skipped, JAX's
``gather_rows(skip=stay)`` of ``native/host_gather.cpp``), read in place
from a pinned host store (or a store on the card), inside the decode step.
What bounds it is the missed chunks' bytes over the host link.
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.core.selection import chunk_ids_to_positions
from shadowkv_tpu_torch.kernels import build


def gather_chunks_plain(
    layer: int,
    slot_ids: torch.Tensor,
    u: torch.Tensor,
    v_full: torch.Tensor,
    u_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    chunk_size: int,
):
    """Plain PyTorch version: the same rows by indexing."""
    b, kh, s = slot_ids.shape
    dev = slot_ids.device
    rows = (slot_ids.long()[..., None] * chunk_size
            + torch.arange(chunk_size, device=dev)).reshape(b, kh, s * chunk_size)
    bi = torch.arange(b, device=dev)[:, None, None]
    ki = torch.arange(kh, device=dev)[None, :, None]
    u_tok = u[layer][bi, rows]
    v_tok = v_full[layer][bi, ki, rows]
    if u_scale is None:
        return u_tok, v_tok, None, None
    return u_tok, v_tok, u_scale[layer][bi, rows], v_scale[layer][bi, ki, rows]


def _check_cuda_args(slot_ids, u, v_full, u_scale, v_scale, chunk_size):
    dev = slot_ids.device
    for t in (slot_ids, u, u_scale, v_scale):
        if t is None:
            continue
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("gather_chunks: ids, U and the scales must be "
                             "contiguous tensors on one CUDA device")
    build.check_v_store(v_full, dev, "gather_chunks")
    if slot_ids.dtype != torch.int32 or slot_ids.dim() != 3:
        raise ValueError("gather_chunks: slot_ids must be [B, K, S] int32")
    b, kh, _ = slot_ids.shape
    if u.dim() != 4 or v_full.dim() != 5 or u.shape[1] != b \
            or v_full.shape[:4] != (u.shape[0], b, kh, u.shape[2]):
        raise ValueError(f"store shapes disagree: ids {tuple(slot_ids.shape)}, "
                         f"u {tuple(u.shape)}, v {tuple(v_full.shape)}")
    l, n_rows = u.shape[0], u.shape[2]
    if n_rows % chunk_size:
        raise ValueError("store rows must be whole chunks")
    quant = u.dtype == torch.int8
    if quant:
        if v_full.dtype != torch.int8:
            raise ValueError("int8 U needs an int8 V store")
        if u_scale is None or v_scale is None \
                or u_scale.dtype != torch.bfloat16 \
                or v_scale.dtype != torch.bfloat16 \
                or u_scale.shape != (l, b, n_rows) \
                or v_scale.shape != (l, b, kh, n_rows):
            raise ValueError("int8 stores need bf16 u_scale [L, B, C*cs] and "
                             "v_scale [L, B, K, C*cs]")
    elif u_scale is not None or v_scale is not None \
            or u.dtype != v_full.dtype:
        raise ValueError("unquantized stores take no scales and share a dtype")
    return quant


def gather_chunks(
    layer: int,
    slot_ids: torch.Tensor,  # [B, K, S] int32 selected chunk ids
    u: torch.Tensor,  # [L, B, C*cs, r] int8 | model dtype
    v_full: torch.Tensor,  # [L, B, K, C*cs, Dh]; CUDA or pinned CPU
    u_scale: torch.Tensor | None = None,  # [L, B, C*cs] bf16 (int8 stores)
    v_scale: torch.Tensor | None = None,  # [L, B, K, C*cs] bf16 (int8 stores)
    *,
    chunk_size: int,
):
    """Gather layer ``layer``'s selected chunks; returns (u_tok, v_tok,
    u_sc, v_sc), the scales None for unquantized stores."""
    if not slot_ids.is_cuda:
        return gather_chunks_plain(layer, slot_ids, u, v_full, u_scale,
                                   v_scale, chunk_size=chunk_size)
    quant = _check_cuda_args(slot_ids, u, v_full, u_scale, v_scale,
                             chunk_size)
    l, b, n_rows, rank = u.shape
    kh, dh = v_full.shape[2], v_full.shape[4]
    if not 0 <= layer < l:
        raise IndexError(f"layer {layer} out of range for {l} layers")
    s = slot_ids.shape[2]
    n = s * chunk_size
    dev = slot_ids.device
    u_tok = torch.empty(b, kh, n, rank, dtype=u.dtype, device=dev)
    v_tok = torch.empty(b, kh, n, dh, dtype=v_full.dtype, device=dev)
    u_sc = v_sc = None
    if quant:
        u_sc = torch.empty(b, kh, n, dtype=torch.bfloat16, device=dev)
        v_sc = torch.empty(b, kh, n, dtype=torch.bfloat16, device=dev)
    lib = build.library()
    gather_chunks.launches += 1
    if not v_full.is_cuda:
        gather_chunks.host_launches += 1
    rc = lib.shadowkv_gather_chunks(
        u[layer].data_ptr(),
        u_scale[layer].data_ptr() if quant else None,
        v_full[layer].data_ptr(),
        v_scale[layer].data_ptr() if quant else None,
        slot_ids.data_ptr(),
        u_tok.data_ptr(), u_sc.data_ptr() if quant else None,
        v_tok.data_ptr(), v_sc.data_ptr() if quant else None,
        b, kh, n_rows, s, chunk_size,
        rank * u.element_size(), dh * v_full.element_size(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gather_chunks")
    return u_tok, v_tok, u_sc, v_sc


gather_chunks.launches = 0  # kernel launches (CUDA path only)
gather_chunks.host_launches = 0  # of which read V from pinned host memory


def gather_v_rows_plain(
    layer: int,
    slot_ids: torch.Tensor,
    stay: torch.Tensor,
    v_full: torch.Tensor,
    *,
    chunk_size: int,
) -> torch.Tensor:
    """Plain PyTorch version: every selected chunk's V rows by indexing,
    then zeros where ``stay`` is set."""
    b, kh, s = slot_ids.shape
    dev = slot_ids.device
    rows = chunk_ids_to_positions(slot_ids, chunk_size)
    bi = torch.arange(b, device=dev)[:, None, None]
    ki = torch.arange(kh, device=dev)[None, :, None]
    v = v_full[layer][bi, ki, rows].view(b, kh, s, chunk_size, -1)
    return torch.where(stay[..., None, None], torch.zeros((), dtype=v.dtype,
                                                          device=dev), v)


def gather_v_rows(
    layer: int,
    slot_ids: torch.Tensor,  # [B, K, S] int32 selected chunk ids
    stay: torch.Tensor,  # [B, K, S] bool: the slot keeps its chunk
    v_full: torch.Tensor,  # [L, B, K, C*cs, Dh]; pinned CPU or CUDA
    *,
    chunk_size: int,
) -> torch.Tensor:
    """Layer ``layer``'s V rows of the chunks that missed, [B, K, S, cs,
    Dh] in the store's dtype. Rows of the slots where ``stay`` is set are
    unspecified (the kernel does not write them; the caller keeps the
    resident rows there)."""
    if not slot_ids.is_cuda:
        return gather_v_rows_plain(layer, slot_ids, stay, v_full,
                                   chunk_size=chunk_size)
    dev = slot_ids.device
    for t in (slot_ids, stay):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("gather_v_rows: ids and stay must be contiguous "
                             "tensors on one CUDA device")
    build.check_v_store(v_full, dev, "gather_v_rows")
    if slot_ids.dtype != torch.int32 or slot_ids.dim() != 3 \
            or stay.dtype != torch.bool or stay.shape != slot_ids.shape:
        raise ValueError("gather_v_rows: slot_ids [B, K, S] int32 and stay "
                         "[B, K, S] bool")
    l, b, kh, n_rows, dh = v_full.shape
    if (b, kh) != tuple(slot_ids.shape[:2]) or n_rows % chunk_size:
        raise ValueError(f"store shapes disagree: ids {tuple(slot_ids.shape)}"
                         f", v {tuple(v_full.shape)}")
    if not 0 <= layer < l:
        raise IndexError(f"layer {layer} out of range for {l} layers")
    s = slot_ids.shape[2]
    out = torch.empty(b, kh, s, chunk_size, dh, dtype=v_full.dtype,
                      device=dev)
    lib = build.library()
    gather_v_rows.launches += 1
    rc = lib.shadowkv_gather_v_rows(
        v_full[layer].data_ptr(), slot_ids.data_ptr(), stay.data_ptr(),
        out.data_ptr(), b, kh, n_rows, s, chunk_size,
        dh * v_full.element_size(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gather_v_rows")
    return out


gather_v_rows.launches = 0  # kernel launches (CUDA path only)

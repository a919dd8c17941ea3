"""Decode attention over a head-major cache: the kernel and its plain
version.

The JAX package computes decode attention as plain einsum math
(``shadowkv_tpu/core/attention.py::decode_attention_hm``), with no Pallas
kernel; ``decode_attention_plain`` is that math in PyTorch. On the card the
plain version upcast the whole bf16 K and V buffer of every layer to f32, so
this kernel (``csrc/decode_attention.cu``) is the port's own: it reads each
bf16 K and V byte once, keeps the f32 sums in registers and shared memory,
and gives the plain version's roundings (f32 scores, P rounded to bf16
after it is normalised, f32 P V, one bf16 rounding of the output).

``decode_attention`` takes the plain version for CPU tensors and launches
the kernel, or raises, for CUDA ones. The kernel serves bf16 q, K and V,
head_dims that are a multiple of 16 up to 128, any GQA group and any S_new;
it allocates nothing itself: the wrapper allocates the output and, where a
range's scores do not fit in shared memory (``plan``), their scratch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from shadowkv_tpu_torch.kernels import build

_F32_MIN = torch.finfo(torch.float32).min


def decode_attention_plain(
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
    ``T_cap``, so the shapes do not depend on it.
    """
    b, s_new, h, dh = q.shape
    kheads, t = k_hm.shape[1], k_hm.shape[2]
    g = h // kheads
    scale = scale if scale is not None else dh**-0.5
    qg = q.reshape(b, s_new, kheads, g, dh)
    scores = torch.einsum("bskgd,bktd->bkgst", qg.float(), k_hm.float()) * scale
    pos_k = torch.arange(t, device=q.device)
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        q_abs = kv_len[:, None] - s_new + torch.arange(s_new, device=q.device)
        mask = (pos_k <= q_abs[..., None])[:, None, None]  # [B, 1, 1, S, T]
    else:
        q_abs = kv_len - s_new + torch.arange(s_new, device=q.device)
        mask = pos_k[None, :] <= q_abs[:, None]  # [S, T]
    scores = torch.where(mask, scores, _F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgst,bktd->bskgd", probs.to(v_hm.dtype).float(), v_hm.float()
    )
    return out.reshape(b, s_new, h, dh).to(q.dtype)


class Plan(NamedTuple):
    """A launch of the kernel: N CTAs per cluster (one (batch row, KV head)
    and row group), n8 tiles of query rows per CTA, row groups of G * S_new
    query rows, dynamic shared memory, and the f32 scratch for the scores
    (0: they stay in shared memory)."""

    cluster: int
    row_tiles: int
    row_groups: int
    smem_bytes: int
    scratch_floats: int


@functools.lru_cache(maxsize=None)
def plan(batch: int, kv_heads: int, rows: int, t_cap: int,
         head_dim: int) -> Plan:
    """The kernel's launch for these shapes on the current card: ``rows`` =
    G * S_new query rows per (batch row, KV head), ``t_cap`` cache rows."""
    out = (ctypes.c_longlong * 5)()
    rc = build.library().shadowkv_decode_attention_plan(
        batch, kv_heads, rows, t_cap, head_dim, out)
    build.check(rc, "decode_attention plan")
    return Plan(*out)


def _check_cuda_args(q, k_hm, v_hm, kv_len) -> None:
    for t in (q, k_hm, v_hm):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError("decode_attention kernel: q, k_hm and v_hm must "
                             "be bf16 CUDA tensors")
        if t.device != q.device:
            raise ValueError("decode_attention: operands on different devices")
    if q.dim() != 4 or k_hm.dim() != 4 or v_hm.shape != k_hm.shape:
        raise ValueError(f"decode_attention: q [B, S, H, Dh] and k/v [B, K, "
                         f"T, Dh]; got {tuple(q.shape)}, {tuple(k_hm.shape)},"
                         f" {tuple(v_hm.shape)}")
    b, _, h, dh = q.shape
    kheads = k_hm.shape[1]
    if k_hm.shape[0] != b or k_hm.shape[3] != dh or h % kheads:
        raise ValueError("decode_attention: q and the cache disagree")
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"decode_attention kernel serves head_dims that are "
                         f"a multiple of 16 up to 128, got {dh}")
    if not (k_hm.is_contiguous() and v_hm.is_contiguous()):
        raise ValueError("decode_attention kernel: k_hm and v_hm must be "
                         "contiguous")
    if q.stride(3) != 1 or any(s % 8 for s in q.stride()[:3]) \
            or any(t.data_ptr() % 16 for t in (q, k_hm, v_hm)):
        raise ValueError("decode_attention kernel: q rows and the buffers "
                         "must start on 16-byte boundaries")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device:
            raise ValueError("decode_attention: kv_len on another device")
        if kv_len.dim() > 1 or (kv_len.dim() == 1 and kv_len.shape[0] != b):
            raise ValueError("decode_attention: kv_len must be 0-d or [B]")


def decode_attention(
    q: torch.Tensor,  # [B, S_new, H, Dh]
    k_hm: torch.Tensor,  # [B, K, T_cap, Dh]
    v_hm: torch.Tensor,  # [B, K, T_cap, Dh]
    kv_len: int | torch.Tensor,  # valid rows incl. the new tokens, 0-d or [B]
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention (``decode_attention_plain``'s function): CPU tensors
    take the plain version, CUDA ones the kernel on the current stream."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_hm, v_hm, kv_len, scale)
    _check_cuda_args(q, k_hm, v_hm, kv_len)
    b, s_new, h, dh = q.shape
    kheads, t_cap = k_hm.shape[1], k_hm.shape[2]
    g = h // kheads
    scale = scale if scale is not None else dh**-0.5
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(torch.int32).contiguous()
        lens_ptr, value, batched = lens.data_ptr(), 0, int(lens.dim() == 1)
    else:
        lens_ptr, value, batched = None, int(kv_len), 0
    p = plan(b, kheads, g * s_new, t_cap, dh)
    out = torch.empty(b, s_new, h, dh, dtype=q.dtype, device=q.device)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=q.device) if p.scratch_floats else None)
    decode_attention.launches += 1
    rc = build.library().shadowkv_decode_attention(
        q.data_ptr(), k_hm.data_ptr(), v_hm.data_ptr(), lens_ptr,
        out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        q.stride(0), q.stride(1), q.stride(2),
        b, kheads, g, s_new, t_cap, dh, value, batched, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "decode_attention")
    return out


decode_attention.launches = 0  # kernel launches (CUDA path only)

"""Causal GQA prefill attention: dense (kernel B) and sink + window (C).

Takes the place of the TPU library kernels that
``shadowkv_tpu/core/attention.py`` reaches: ``causal_prefill_splash``
(splash MQA, K/V consumed per GQA group) and ``causal_prefill_flash``
(flash attention, K/V repeated to H heads) compute the same function, so
both names route to kernel B; ``sparse_prefill_splash`` (splash MQA under
the sink + sliding-window mask) is kernel C, the same flash loop given a
window and a sink, which skips every key tile outside both. Both kernels
live in ``csrc/prefill_attention.cu`` and read KV head ``h // G`` for query
head ``h`` without repeating K/V. Their plain versions, taken for CPU
tensors, are ``core/attention.py::causal_prefill_attention`` and
``sparse_prefill_attention``; each wrapper counts its own launches.
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.core.attention import (
    causal_prefill_attention,
    sparse_prefill_attention,
)
from shadowkv_tpu_torch.kernels import build


def _check(q, k, v):
    b, s, h, dh = q.shape
    kh = k.shape[2]
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("prefill attention kernel: q/k/v must be "
                             "contiguous bf16 CUDA tensors")
    if k.shape != (b, s, kh, dh) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, S, K, Dh] matching q {tuple(q.shape)}")
    if dh != 128 or h % kh != 0:
        raise ValueError(f"kernel serves head_dim 128 and H % K == 0 "
                         f"(got Dh {dh}, H {h}, K {kh})")


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
    _check(q, k, v)
    out = torch.empty_like(q)
    lib = build.library()
    causal_prefill_splash.launches += 1
    rc = lib.shadowkv_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], dh, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "prefill attention")
    return out


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
    _check(q, k, v)
    out = torch.empty_like(q)
    lib = build.library()
    sparse_prefill_splash.launches += 1
    # Beyond the sequence a larger window or sink changes nothing.
    rc = lib.shadowkv_sparse_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], dh, float(scale),
        max(0, min(int(window), s)), max(0, min(int(sink), s)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "sparse prefill attention")
    return out


sparse_prefill_splash.launches = 0  # kernel launches (CUDA path only)


causal_prefill_splash.launches = 0  # kernel launches (CUDA path only)

# The flash variant repeated K/V to H heads for the TPU library kernel; the
# function is the same, so it is the same kernel here.
causal_prefill_flash = causal_prefill_splash

"""Rotary position embeddings (counterpart of ``shadowkv_tpu/core/rope.py``).

Two styles, as in the JAX package:

- 'neox' (llama / yi / qwen2 / phi3): rotate-half over the whole head dim;
- 'glm' (GLM-4): interleaved (even, odd) pairs over the first
  ``rope_dim`` dims, the rest passed through.

The prefill/decode path rotates with cos/sin TABLES (bf16 when the model is
bf16, as the engine builds them); the refresh kernel computes f32 trig from
``inv_freq_full_neox`` instead, and the XLA-gather decode branch rotates
rebuilt K rows in two stages with ``rotate_with_tables``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shadowkv_tpu_torch.config import ModelConfig


def _llama3_scale_inv_freq(inv_freq: np.ndarray, scaling: dict) -> np.ndarray:
    """Llama-3.1 NTK-by-parts frequency scaling, in float64 (HF semantics;
    one cast to f32 afterwards matches HF's tables)."""
    factor = scaling["factor"]
    low_freq_factor = scaling.get("low_freq_factor", 1.0)
    high_freq_factor = scaling.get("high_freq_factor", 4.0)
    old_max = scaling.get("original_max_position_embeddings", 8192)
    low_freq_wavelen = old_max / low_freq_factor
    high_freq_wavelen = old_max / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_max / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(is_medium, smoothed, scaled)


def compute_inv_freq(cfg: ModelConfig) -> torch.Tensor:
    """[rope_dim // 2] f32 inverse frequencies (float64 internally)."""
    dim = cfg.rope_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    )
    scaling = cfg.rope_scaling_dict
    if scaling and scaling.get("rope_type") in ("llama3", "llama3.1"):
        inv_freq = _llama3_scale_inv_freq(inv_freq, scaling)
    return torch.from_numpy(inv_freq.astype(np.float32))


def compute_cos_sin(
    cfg: ModelConfig, max_len: int, dtype=torch.float32, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each [max_len, rope_dim // 2], f32 math cast to
    ``dtype``."""
    inv_freq = compute_inv_freq(cfg).to(device)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def inv_freq_full_neox(cfg: ModelConfig) -> torch.Tensor:
    """[head_dim] per-lane inverse frequencies for the refresh kernel's RoPE:
    neox duplicates the half table (lane l pairs with l +- Dh/2); glm gives
    lane l < rope_dim the frequency invf[l // 2] and 0 past rope_dim."""
    invf = compute_inv_freq(cfg)
    if cfg.rope_style == "neox":
        if cfg.rope_dim != cfg.head_dim:
            raise ValueError("neox RoPE rotates the whole head")
        return torch.cat([invf, invf])
    full = torch.zeros(cfg.head_dim, dtype=torch.float32)
    full[: cfg.rope_dim] = torch.repeat_interleave(invf, 2)
    return full


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    style: str = "neox",
) -> torch.Tensor:
    """Rotate x [B, seq, H, head_dim] by cos/sin [seq, rope_dim // 2], or
    [B, seq, rope_dim // 2] when each sequence sits at its own position.

    bf16 inputs rotate in bf16 (as the JAX package does, to avoid an f32
    copy of the whole prefill); other dtypes rotate in f32.
    """
    orig_dtype = x.dtype
    half = cos.shape[-1]
    xf = x if x.dtype == torch.bfloat16 else x.float()
    lead = cos.shape[:2] if cos.dim() == 3 else (1, cos.shape[0])
    c = cos.reshape(*lead, 1, half).to(xf.dtype)
    s = sin.reshape(*lead, 1, half).to(xf.dtype)
    if style == "neox":
        if 2 * half != x.shape[-1]:
            raise ValueError("neox tables must cover the whole head")
        cf = torch.cat([c, c], dim=-1)
        sf = torch.cat([-s, s], dim=-1)
        out = xf * cf + torch.roll(xf, half, dims=-1) * sf
    elif style == "glm":
        rot = 2 * half
        xr, x_pass = xf[..., :rot], xf[..., rot:]
        x_even, x_odd = xr[..., 0::2], xr[..., 1::2]
        r_even = x_even * c - x_odd * s
        r_odd = x_odd * c + x_even * s
        rotated = torch.stack([r_even, r_odd], dim=-1).reshape(xr.shape)
        out = torch.cat([rotated, x_pass], dim=-1)
    else:
        raise ValueError(f"unknown rope style: {style}")
    return out.to(orig_dtype)


def rotate_with_tables(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    style: str = "neox",
) -> torch.Tensor:
    """Rotate x [..., head_dim] by cos/sin [..., rope_dim // 2] that
    broadcast against x's leading dims; f32 math, one cast back to x's
    dtype (JAX ``rotate_with_tables``)."""
    orig_dtype = x.dtype
    half = cos.shape[-1]
    xf, c, s = x.float(), cos.float(), sin.float()
    if style == "neox":
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    elif style == "glm":
        rot = 2 * half
        xr, x_pass = xf[..., :rot], xf[..., rot:]
        x_even, x_odd = xr[..., 0::2], xr[..., 1::2]
        r_even = x_even * c - x_odd * s
        r_odd = x_odd * c + x_even * s
        rotated = torch.stack([r_even, r_odd], dim=-1).reshape(xr.shape)
        out = torch.cat([rotated, x_pass], dim=-1)
    else:
        raise ValueError(f"unknown rope style: {style}")
    return out.to(orig_dtype)


def half_inv_freq(inv_freq_full: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``compute_inv_freq(cfg)`` read back out of ``inv_freq_full_neox``'s
    per-lane table (neox: its first half; glm: its even lanes), so a
    caller that holds the table on the card needs no second copy."""
    if cfg.rope_style == "neox":
        return inv_freq_full[: cfg.rope_dim // 2]
    return inv_freq_full[: cfg.rope_dim : 2]

"""Attention of the PyTorch port against the JAX package on the same numpy
inputs (float32): the plain prefill attention (the CPU side of the prefill
kernel) against JAX's blockwise reference and its splash kernel in
interpret mode, and decode attention with kv_len masking (on CPU tensors
the wrapper of the decode-attention kernel takes the plain version: the
same bits, no launch). Tolerances:
atol = rtol = 1e-5, 2e-4 against splash (the JAX tests' own bound for the
kernel's online softmax)."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.core import attention as ja
from shadowkv_tpu_torch.core import attention as ta
from shadowkv_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_flash,
    causal_prefill_splash,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, s, h, kh, dh=128, t=None):
    rng = np.random.default_rng(seed)
    t = t or s
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g, s", [(2, 200), (4, 200), (4, 72)])
def test_causal_prefill_matches_jax_blockwise(g, s):
    q, k, v = _qkv(g * s, 2, s, 2 * g, 2)
    ref = np.asarray(ja.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        ta.causal_prefill_attention(*t, block_q=64).numpy(), ref, **TOL)
    # the kernel wrapper takes the plain version for CPU tensors
    np.testing.assert_allclose(causal_prefill_splash(*t).numpy(), ref, **TOL)
    np.testing.assert_allclose(causal_prefill_flash(*t).numpy(), ref, **TOL)


@pytest.mark.parametrize("g", [2, 4])
def test_causal_prefill_matches_jax_splash_interpret(g):
    q, k, v = _qkv(10 + g, 1, 256, 2 * g, 2)
    ref = np.asarray(ja.causal_prefill_splash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    out = causal_prefill_splash(*[torch.from_numpy(a) for a in (q, k, v)])
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_mha_masked():
    q, k, v = _qkv(3, 2, 5, 4, 2, t=9)
    mask = np.random.default_rng(4).random((1, 1, 1, 5, 9)) < 0.7
    mask[..., 0] = True
    ref = np.asarray(ja.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jnp.asarray(mask)))
    out = ta.mha(*[torch.from_numpy(a) for a in (q, k, v)],
                 mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("s_new, kv_len", [(1, 37), (3, 50), (1, 64)])
def test_decode_attention_hm(s_new, kv_len):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((2, s_new, 4, 128)).astype(np.float32)
    k = rng.standard_normal((2, 2, 64, 128)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 128)).astype(np.float32)
    ref = np.asarray(ja.decode_attention_hm(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    out = ta.decode_attention_hm(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("kv_len", [40, "slots"])
def test_decode_attention_takes_the_plain_version_on_cpu(kv_len):
    """bf16 CPU tensors, 0-d or [B] lengths: ``decode_attention_hm`` and the
    kernel's wrapper give the plain version's bits and launch nothing."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 2, 8, 32, generator=gen).bfloat16()
    k = torch.randn(2, 2, 64, 32, generator=gen).bfloat16()
    v = torch.randn(2, 2, 64, 32, generator=gen).bfloat16()
    lens = (torch.tensor([64, 5], dtype=torch.int32) if kv_len == "slots"
            else torch.tensor(kv_len, dtype=torch.int32))
    before = decode_attention.launches
    ref = decode_attention_plain(q, k, v, lens)
    assert torch.equal(decode_attention(q, k, v, lens), ref)
    assert torch.equal(ta.decode_attention_hm(q, k, v, lens), ref)
    assert decode_attention.launches == before

"""Attention sink + sliding window prefill (``prefill_pattern="stream"``,
kernel C). Its plain version, which the wrapper takes on the CPU, against
JAX's ``sparse_prefill_splash`` run as the JAX tests run it (interpret
mode), at f32 with window and sink below S (the splash kernel takes S in
multiples of 128 up to 1024), and at a ragged S against JAX's masked
``mha`` with the splash mask's formula: within atol = rtol = 1e-5 (JAX
scales K before the product and runs an online softmax; f32 sums in
another order).

The JAX engine runs ``stream`` as dense causal attention on the CPU (its
splash branch needs an accelerator), while the port's CPU path is kernel
C's plain version. So the port's ``stream`` engine is held to JAX's with a
window covering the prompt, and shown to change the logits with a
smaller one."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.core.attention import mha as j_mha
from shadowkv_tpu.core.attention import sparse_prefill_splash as j_splash
from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.config import RuntimeConfig as TRuntime
from shadowkv_tpu_torch.core.attention import sparse_prefill_attention
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_splash,
    sparse_prefill_splash,
)
from shadowkv_tpu_torch.models.engine import Engine as TEngine
from torch_toy import PROMPT, compare, models  # noqa: F401 (fixture)


def _qkv(s):
    rng = np.random.default_rng(s)
    return tuple(rng.standard_normal((1, s, h, 128)).astype(np.float32)
                 for h in (4, 2, 2))


@pytest.mark.parametrize("s, window, sink", [(512, 128, 64), (384, 100, 32),
                                             (256, 64, 0)])
def test_stream_plain_matches_jax_splash(s, window, sink):
    q, k, v = _qkv(s)
    j = j_splash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, sink,
                 interpret=True)
    t = sparse_prefill_splash(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window, sink)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    assert sparse_prefill_splash.launches == 0  # CUDA launches only


def test_stream_plain_matches_jax_mask_at_ragged_s():
    s, window, sink = 300, 100, 32
    q, k, v = _qkv(s)
    pos = np.arange(s)
    mask = (pos[None] <= pos[:, None]) & (
        (pos[None] < sink) | (pos[:, None] - pos[None] < window))
    j = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              mask=jnp.asarray(mask)[None, None, None])
    t = sparse_prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window, sink, block_q=128)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_stream_plain_is_causal_when_window_covers_all():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 130, h, 32))
                                .astype(np.float32)) for h in (4, 2, 2))
    torch.testing.assert_close(
        sparse_prefill_attention(q, k, v, 130, 0),
        causal_prefill_splash(q, k, v), atol=0, rtol=0)


def test_stream_engine_matches_jax_with_covering_window(models):
    compare(models, "full", prefill_pattern="stream", stream_window=PROMPT,
            stream_sink=16)


def test_stream_engine_window_changes_logits(models):
    tcfg, tparams, ids = models[2], models[3], models[-1]
    cc = TCache(max_length=PROMPT + 32)

    def logits(**rt_kw):
        return TEngine(tcfg, cc, TRuntime(**rt_kw), tparams,
                       device="cpu").prefill(ids)[0]

    dense = logits()
    covering = logits(prefill_pattern="stream", stream_window=PROMPT,
                      stream_sink=0)
    windowed = logits(prefill_pattern="stream", stream_window=128,
                      stream_sink=32)
    torch.testing.assert_close(covering, dense, atol=0, rtol=0)
    assert float((windowed - dense).abs().max()) > 1e-2

"""The port's chunk gather (kernel D; its plain version runs for CPU ids)
against the JAX package's ``gather_chunks`` in interpret mode and its
``gather_chunks_reference``, over float32, bf16 and int8 stores.

The layouts differ (the JAX package tiles int8 chunks and folds the bf16
scales into U's tail lanes; the port keeps row-major stores with the scales
in their own tensors), so both packages pack their stores from the same
float values and the test compares the gathered rows after dequantization.
Gathering moves bytes only, so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.core.quant import pack_shadow_int8, scale_lanes_for, scales_from_bytes
from shadowkv_tpu.kernels.gather import gather_chunks as j_gather
from shadowkv_tpu.kernels.gather import gather_chunks_reference as j_gather_ref
from shadowkv_tpu_torch.core.quant import quantize_store
from shadowkv_tpu_torch.kernels.gather import gather_chunks, gather_chunks_plain

L, B, K, DH, RANK = 3, 2, 4, 128, 40


def _stores(seed, c, cs, s):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((L, B, c, cs, RANK)).astype(np.float32)
    v = rng.standard_normal((L, B, K, c, cs, DH)).astype(np.float32)
    ids = rng.integers(0, c, (B, K, s)).astype(np.int32)
    return u, v, ids


def _jax_rows(u, v, ids, layer, cs, dtype):
    """Dequantized (u_tok [B, K, S*cs, RANK], v_tok [B, K, S*cs, DH]) from the
    JAX kernel in interpret mode and from its jnp reference."""
    if dtype == "int8":
        sl = scale_lanes_for(K)
        rp = ((RANK + sl + 127) // 128) * 128
        u_pad = np.zeros(u.shape[:-1] + (rp,), np.float32)
        u_pad[..., :RANK] = u
        u_in, v_in = pack_shadow_int8(jnp.asarray(u_pad), jnp.asarray(v), rank=RANK)
        tile_sub = 32
    else:
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        u_in, v_in, tile_sub = jnp.asarray(u, jdt), jnp.asarray(v, jdt), cs
    outs = []
    for fn, kw in ((j_gather, dict(interpret=True)), (j_gather_ref, {})):
        u_tok, v_tok = fn(jnp.int32(layer), jnp.asarray(ids), u_in, v_in,
                          chunk_size=cs, tile_sub=tile_sub, **kw)
        u_tok, v_tok = np.asarray(u_tok), np.asarray(v_tok)
        if dtype == "int8":
            base = rp - sl
            u_sc = np.asarray(scales_from_bytes(u_tok[..., base], u_tok[..., base + 1]),
                              np.float32)
            ki = np.arange(K)[None, :, None]
            v_sc = np.asarray(scales_from_bytes(
                np.take_along_axis(u_tok[..., base + 2:base + 2 + K], ki[..., None], -1)[..., 0],
                np.take_along_axis(u_tok[..., base + 2 + K:base + 2 + 2 * K],
                                   ki[..., None], -1)[..., 0]), np.float32)
            u_tok = u_tok[..., :RANK].astype(np.float32) * u_sc[..., None]
            v_tok = v_tok.astype(np.float32) * v_sc[..., None]
        outs.append((np.asarray(u_tok, np.float32), np.asarray(v_tok, np.float32)))
    return outs


def _port_rows(u, v, ids, layer, cs, dtype, fn=gather_chunks):
    c = u.shape[2]
    ut = torch.from_numpy(u.reshape(L, B, c * cs, RANK))
    vt = torch.from_numpy(v.reshape(L, B, K, c * cs, DH))
    u_sc = v_sc = None
    if dtype == "int8":
        ut, u_sc = quantize_store(ut)
        vt, v_sc = quantize_store(vt)
    elif dtype == "bfloat16":
        ut, vt = ut.bfloat16(), vt.bfloat16()
    u_tok, v_tok, gu, gv = fn(layer, torch.from_numpy(ids), ut, vt, u_sc, v_sc,
                              chunk_size=cs)
    assert u_tok.shape == (B, K, ids.shape[-1] * cs, RANK)
    assert v_tok.shape == (B, K, ids.shape[-1] * cs, DH)
    assert u_tok.dtype == ut.dtype and v_tok.dtype == vt.dtype
    if dtype == "int8":
        assert gu.shape == gv.shape == (B, K, ids.shape[-1] * cs)
        return ((u_tok.float() * gu.float()[..., None]).numpy(),
                (v_tok.float() * gv.float()[..., None]).numpy())
    assert gu is None and gv is None
    return u_tok.float().numpy(), v_tok.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cs", [8, 16])
def test_gather_matches_jax(dtype, cs):
    u, v, ids = _stores(cs, c=40, cs=cs, s=12)
    (uk, vk), (ur, vr) = _jax_rows(u, v, ids, 1, cs, dtype)
    np.testing.assert_array_equal(uk, ur)  # the JAX kernel = its reference
    np.testing.assert_array_equal(vk, vr)
    up, vp = _port_rows(u, v, ids, 1, cs, dtype)
    np.testing.assert_array_equal(up, ur)
    np.testing.assert_array_equal(vp, vr)


def test_wrapper_takes_plain_version_on_cpu():
    u, v, ids = _stores(3, c=24, cs=16, s=8)
    for layer in range(L):
        a = _port_rows(u, v, ids, layer, 16, "int8")
        b = _port_rows(u, v, ids, layer, 16, "int8", fn=gather_chunks_plain)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert gather_chunks.launches == 0  # launches count CUDA kernels only
    assert gather_chunks.host_launches == 0

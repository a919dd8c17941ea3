"""Segmented decode attention (``RuntimeConfig.decode_segmented``) in the
PyTorch port, against the JAX package on the CPU (``tests/test_segmented.py``
is the JAX side).

- ``decode_attention_segments`` over a cache split into prefix / sparse /
  gen segments against the port's ``decode_attention_hm`` over the whole
  cache and against JAX's ``decode_attention_segments`` on the same
  inputs, with a [B] and a 0-d ``kv_len``: atol 2e-5 (f32; the sum of
  per-segment P @ V products rounds otherwise than one product).
- Engines on the float32 toy model of ``tests/test_segmented.py`` (3
  layers, head_dim 32, the JAX weights from ``PRNGKey(3)`` and the JAX
  sketch): greedy tokens and cached chunk ids of ``decode_segmented=True``
  equal JAX's with ``decode_segmented=True`` on the XLA-gather branch (by
  tensor indexing and through the chunk-gather kernel, ``ring``), and
  equal the port's own unsegmented tokens, on unquantized and int8
  stores; the fused refresh ignores the setting.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.config import RuntimeConfig as JRuntime
from shadowkv_tpu.core.attention import decode_attention_segments as j_segs
from shadowkv_tpu.models.engine import Engine as JEngine
from shadowkv_tpu.models.params import init_synthetic_params as j_init
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.config import RuntimeConfig as TRuntime
from shadowkv_tpu_torch.core.attention import (
    decode_attention_hm,
    decode_attention_segments,
)
from shadowkv_tpu_torch.models.engine import Engine as TEngine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.models.registry import toy_config as t_toy
from test_torch_serving import _one_intra_op_thread  # noqa: F401

SIZES = (16, 48, 24)  # prefix / sparse / gen rows


@pytest.mark.parametrize("per_slot", [True, False])
def test_segments_match_hm_and_jax(per_slot):
    rng = np.random.RandomState(0)
    b, k, g, dh, s_new = 2, 2, 3, 32, 1
    t = sum(SIZES)
    q = rng.randn(b, s_new, k * g, dh).astype(np.float32)
    kk = rng.randn(b, k, t, dh).astype(np.float32)
    vv = rng.randn(b, k, t, dh).astype(np.float32)
    kv = np.array([t - 10, t - 3]) if per_slot else np.array(t - 7)
    j_list, t_list, off = [], [], 0
    for i, n in enumerate(SIZES):
        masked = i == len(SIZES) - 1
        j_list.append((jnp.asarray(kk[:, :, off:off + n]),
                       jnp.asarray(vv[:, :, off:off + n]), off, masked))
        t_list.append((torch.from_numpy(kk[:, :, off:off + n]),
                       torch.from_numpy(vv[:, :, off:off + n]), off, masked))
        off += n
    kv_t = torch.from_numpy(kv.astype(np.int32))
    got = decode_attention_segments(torch.from_numpy(q), t_list, kv_t)
    hm = decode_attention_hm(torch.from_numpy(q), torch.from_numpy(kk),
                             torch.from_numpy(vv), kv_t)
    want = j_segs(jnp.asarray(q), j_list, jnp.asarray(kv))
    assert got.shape == (b, s_new, k * g, dh)
    np.testing.assert_allclose(got.numpy(), hm.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _models():
    jcfg = j_toy(name="t", num_layers=3, hidden_size=128, num_heads=4,
                 num_kv_heads=2, head_dim=32, intermediate_size=256,
                 vocab_size=128, dtype=jnp.float32)
    tcfg = t_toy(name="t", num_layers=3, hidden_size=128, num_heads=4,
                 num_kv_heads=2, head_dim=32, intermediate_size=256,
                 vocab_size=128, dtype=torch.float32)
    jparams = j_init(jcfg, jax.random.PRNGKey(3))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


_MODELS = {}


def _gen(pkg, segmented, quant, **rt_kw):
    """Greedy tokens (12) and final cached ids of one engine of the JAX
    package (``pkg="jax"``) or the port on the toy of
    ``tests/test_segmented.py``."""
    if not _MODELS:
        _MODELS["m"] = _models()
    jcfg, jparams, tcfg, tparams = _MODELS["m"]
    kw = dict(mode="shadow", max_length=640, sparse_budget=64, rank=16,
              chunk_size=8, local_chunks=2, outlier_chunks=2, kv_quant=quant)
    ids = np.random.RandomState(0).randint(0, 128, (2, 512))
    if pkg == "jax":
        eng = JEngine(jcfg, JCache(**kw), JRuntime(
            prefill_sub_batch=1, decode_segmented=segmented, **rt_kw), jparams)
    else:
        d = jcfg.num_kv_heads * jcfg.head_dim
        omega = jax.random.normal(jax.random.PRNGKey(7), (d, min(d, 16 + 32)),
                                  jnp.float32)
        eng = TEngine(tcfg, TCache(**kw), TRuntime(
            prefill_sub_batch=1, decode_segmented=segmented, **rt_kw),
            tparams, device="cpu", sketch=torch.from_numpy(np.array(omega)))
    toks, _ = eng.generate(ids, gen_len=12)
    return np.asarray(toks), np.asarray(eng._cache.cached_ids)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("branch", ["xla-gather", "ring"])
def test_segmented_tokens_match_jax(branch, quant):
    rt_kw = dict(ring_gather=True) if branch == "ring" else {}
    t_seg, t_ids = _gen("torch", True, quant, **rt_kw)
    t_view, _ = _gen("torch", False, quant, **rt_kw)
    j_seg, j_ids = _gen("jax", True, quant, **rt_kw)
    np.testing.assert_array_equal(t_seg, j_seg)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_seg, t_view)


def test_fused_path_ignores_segmented():
    t_seg, t_ids = _gen("torch", True, "none", use_pallas=True)
    t_view, v_ids = _gen("torch", False, "none", use_pallas=True)
    np.testing.assert_array_equal(t_seg, t_view)
    np.testing.assert_array_equal(t_ids, v_ids)


@pytest.mark.parametrize("branch", ["xla-gather", "ring"])
def test_engine_segments_cover_each_layer_buffer(branch, monkeypatch):
    """Inside a segmented engine's decode, the segments handed to the
    attention at each layer are the static prefix, the sparse region and
    the gen region of that layer's buffers, in order (only the gen region
    masked), and their attention equals the stacked attention over the
    whole buffer with the engine's query and lengths."""
    from shadowkv_tpu_torch.models import forward

    if not _MODELS:
        _MODELS["m"] = _models()
    _, _, tcfg, tparams = _MODELS["m"]
    eng = TEngine(tcfg, TCache(
        mode="shadow", max_length=640, sparse_budget=64, rank=16,
        chunk_size=8, local_chunks=2, outlier_chunks=2), TRuntime(
        ring_gather=branch == "ring", decode_segmented=True), tparams,
        device="cpu")
    ids = np.random.RandomState(0).randint(0, 128, (2, 512))
    calls = []

    def witness(q, segs, kv_len):
        layer = len(calls) % tcfg.num_layers
        cache = eng._cache
        lo = cache.layout
        assert [s[2] for s in segs] == [0, lo.sparse_start, lo.sparse_end]
        assert [s[3] for s in segs] == [False, False, True]
        for i, buf in ((0, cache.k_buf), (1, cache.v_buf)):
            assert torch.equal(torch.cat([s[i] for s in segs], dim=2),
                               buf[layer])
        got = decode_attention_segments(q, segs, kv_len)
        want = decode_attention_hm(q, cache.k_buf[layer], cache.v_buf[layer],
                                   kv_len)
        calls.append(float((got - want).abs().max()))
        return got

    monkeypatch.setattr(forward, "decode_attention_segments", witness)
    eng.generate(ids, gen_len=4)  # the prefill's token, then 3 steps
    assert len(calls) == 3 * tcfg.num_layers
    assert max(calls) <= 2e-5

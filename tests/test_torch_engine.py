"""The slice as a whole: the port's Engine against the JAX package's Engine
on a float32 toy model (head_dim 128, hidden 512, 4 heads / 2 KV heads,
2 layers) with the same numpy weights (carried by ``from_jax_params``), the
same prompt and the same low-rank sketch.

Shadow mode runs the fused-refresh decode (``use_pallas=True``: the JAX
Pallas kernel in interpret mode, the port's plain kernel versions) and the
XLA-gather branch (``use_pallas=None``, the JAX default) on int8 stores
with chunk 16 (and on unquantized stores). Checks: prefill logits
within atol 1e-4 (+ rtol 1e-5); greedy tokens equal; cached chunk ids
equal; compact buffers within 5 % of their largest entry on int8 stores
(the two f32 factorizations round some U entries to neighbouring int8
values, and a reconstructed K row carries that step times its SV row) and
within 0.1 % on unquantized ones. The ``mode="full"`` baseline gets the
same checks on its dense cache (atol 1e-3 + rtol 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.config import RuntimeConfig as JRuntime
from shadowkv_tpu.core.layers import LayerParams as JLayer
from shadowkv_tpu.core.layers import ModelParams as JModel
from shadowkv_tpu.models.engine import Engine as JEngine
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.config import RuntimeConfig as TRuntime
from shadowkv_tpu_torch.models.engine import Engine as TEngine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.models.registry import toy_config as t_toy

SHAPE = dict(head_dim=128, hidden_size=512, num_heads=4, num_kv_heads=2,
             intermediate_size=1024)
PROMPT, BATCH, GEN = 512, 2, 8
RANK = 160


@pytest.fixture(scope="module")
def models():
    jcfg = j_toy(dtype=jnp.float32, **SHAPE)
    tcfg = t_toy(dtype=torch.float32, **SHAPE)
    rng = np.random.default_rng(0)
    l, d, i, v = jcfg.num_layers, jcfg.hidden_size, jcfg.intermediate_size, jcfg.vocab_size
    qkv = (jcfg.num_heads + 2 * jcfg.num_kv_heads) * jcfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    np_params = JModel(
        embed=w(v, d),
        layers=JLayer(
            attn_norm=1.0 + 0.1 * w(l, d), wqkv=w(l, d, qkv), bqkv=None,
            wo=w(l, jcfg.q_size, d), mlp_norm=1.0 + 0.1 * w(l, d),
            w_gate_up=w(l, d, 2 * i), w_down=w(l, i, d),
        ),
        final_norm=1.0 + 0.1 * w(d),
        lm_head=w(d, v),
    )
    ids = rng.integers(1, v, (BATCH, PROMPT))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            from_jax_params(np_params, device="cpu"), ids)


def _engines(models, rt_kw=None, t_cache_kw=None, **cache_kw):
    """A JAX and a port engine on the same weights and sketch; ``rt_kw``
    sets both runtimes (default: the fused refresh), ``t_cache_kw``
    overrides the port's cache config only."""
    jcfg, jparams, tcfg, tparams, _ = models
    rt_kw = dict(use_pallas=True) if rt_kw is None else rt_kw
    kw = dict(max_length=PROMPT + 32, sparse_budget=128, rank=RANK,
              chunk_size=16, outlier_chunks=4, gen_capacity=32, **cache_kw)
    je = JEngine(jcfg, JCache(**kw), JRuntime(prefill_block_q=128, **rt_kw),
                 jparams)
    # JAX draws its sketch from PRNGKey(7) inside lowrank_kv_factors; hand
    # the port the same one.
    d = jcfg.num_kv_heads * jcfg.head_dim
    omega = jax.random.normal(jax.random.PRNGKey(7), (d, min(d, RANK + 32)),
                              jnp.float32)
    te = TEngine(tcfg, TCache(**dict(kw, **(t_cache_kw or {}))),
                 TRuntime(**rt_kw), tparams,
                 device="cpu", sketch=torch.from_numpy(np.array(omega)))
    return je, te


def _compare_decode(je, te, ids, kv_quant):
    """Greedy tokens and cached ids equal; compact buffers close (see the
    module docstring for the tolerances)."""
    jt, _ = je.generate(ids, gen_len=GEN)
    tt, _ = te.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, jt)
    jc, tc = je._cache, te._cache
    assert tc.gen_len == int(jc.gen_len) == GEN - 1
    np.testing.assert_array_equal(tc.cached_ids.numpy(), np.asarray(jc.cached_ids))
    frac = 5e-2 if kv_quant == "int8" else 1e-3
    _close_rel(tc.k_buf.numpy(), jc.k_buf, frac)
    _close_rel(tc.v_buf.numpy(), jc.v_buf, frac)


def _close_rel(a, b, frac):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= frac * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_shadow_engine_matches_jax(models, kv_quant):
    je, te = _engines(models, mode="shadow", kv_quant=kv_quant)
    ids = models[-1]
    jl, _ = je.prefill(ids)
    tl, _ = te.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    _compare_decode(je, te, ids, kv_quant)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_xla_gather_engine_matches_jax(models, kv_quant):
    """The XLA-gather decode branch (use_pallas=None, the JAX default):
    every selected chunk gathered, hits kept by a select, K rotated in two
    stages."""
    je, te = _engines(models, rt_kw=dict(use_pallas=None), mode="shadow",
                      kv_quant=kv_quant)
    assert not te.use_kernel and not te.ring_gather
    _compare_decode(je, te, models[-1], kv_quant)


def test_forced_hit_rate_engine_matches_jax(models):
    """The benchmark-only forced selection (``debug_hit_rate``) on the
    XLA-gather engine: JAX's ids, tokens and buffers, and a sampled slot hit
    rate equal to the forced one (8 slots, the window slides by 2)."""
    rt_kw = dict(use_pallas=None, debug_hit_rate=0.75, track_hit_rate=True,
                 pallas_auto_interval=2)
    je, te = _engines(models, rt_kw=rt_kw, mode="shadow", kv_quant="int8")
    _compare_decode(je, te, models[-1], "int8")
    assert te.kv_stats()["hit_rate_mean"] == 0.75


def test_full_engine_matches_jax(models):
    je, te = _engines(models, mode="full")
    ids = models[-1]
    jl, _ = je.prefill(ids)
    tl, _ = te.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    jt, _ = je.generate(ids, gen_len=GEN)
    tt, _ = te.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, jt)
    jc, tc = je._cache, te._cache
    assert tc.length == int(jc.length) == PROMPT + GEN - 1
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-3, rtol=1e-5)


def test_batch_generate_and_hit_rate(models):
    """batch_generate's timed tokens continue generate's greedy stream, and
    kv_stats reports the sampled slot hit rate."""
    _, _, tcfg, tparams, ids = models
    kw = dict(max_length=PROMPT + 32, sparse_budget=128, rank=RANK,
              chunk_size=16, outlier_chunks=4, gen_capacity=32,
              mode="shadow", kv_quant="int8")
    rt = TRuntime(use_pallas=True, track_hit_rate=True, pallas_auto_interval=2)
    te = TEngine(tcfg, TCache(**kw), rt, tparams, device="cpu")
    full, _ = te.generate(ids, gen_len=6)
    out, stats = te.batch_generate(ids, gen_len=4, temperature=0.0,
                                   warmup_steps=1)
    np.testing.assert_array_equal(out, full[:, 2:6])
    assert stats.decode_tokens == BATCH * 4
    kv = te.kv_stats()
    assert kv["cached"] == PROMPT + 5
    assert kv["hit_samples"] >= 2 and 0.0 <= kv["hit_rate_mean"] <= 1.0
    with pytest.raises(ValueError, match="gen_capacity"):
        te.batch_generate(ids, gen_len=32, warmup_steps=2)


@pytest.mark.parametrize("mode", ["shadow", "full"])
def test_sub_batched_prefill_matches_whole_batch(models, mode):
    """Prefill in sub-batches of one sequence writes the same cache and
    logits as one whole-batch prefill (batch offsets into one cache)."""
    _, _, tcfg, tparams, ids = models
    kw = dict(max_length=PROMPT + 32, sparse_budget=128, rank=RANK,
              chunk_size=16, outlier_chunks=4, gen_capacity=32, mode=mode,
              kv_quant="int8")
    out = []
    for sub in (1, 4):
        te = TEngine(tcfg, TCache(**kw),
                     TRuntime(use_pallas=True, prefill_sub_batch=sub),
                     tparams, device="cpu")
        out.append(te.prefill(ids))
    (l1, c1), (l4, c4) = out
    np.testing.assert_allclose(l1.numpy(), l4.numpy(), atol=1e-4, rtol=1e-5)
    names = ("k_buf", "v_buf", "cached_ids", "u", "v_full") \
        if mode == "shadow" else ("k", "v")
    for name in names:
        a, b = getattr(c1, name).float(), getattr(c4, name).float()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), name

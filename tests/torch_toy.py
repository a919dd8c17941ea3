"""A float32 toy model for the port-vs-JAX engine tests of the sparse
prefill (head_dim 128, hidden 512, 4 heads / 2 KV heads, 2 layers): the
same numpy weights, prompt and low-rank sketch for both packages."""

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
PROMPT, BATCH, GEN = 512, 2, 6
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


def _cache_kw(mode, kv_quant="int8"):
    return dict(mode=mode, max_length=PROMPT + 32, sparse_budget=128,
                rank=RANK, chunk_size=16, outlier_chunks=4, gen_capacity=32,
                kv_quant=kv_quant)


def _sketch(jcfg):
    """JAX draws its sketch from PRNGKey(7) inside lowrank_kv_factors; the
    port is handed the same one."""
    d = jcfg.num_kv_heads * jcfg.head_dim
    omega = jax.random.normal(jax.random.PRNGKey(7), (d, min(d, RANK + 32)),
                              jnp.float32)
    return torch.from_numpy(np.array(omega))


def port_engine(models, mode, kv_quant="int8", **rt_kw):
    """The port's engine of ``engines`` alone (no JAX engine)."""
    jcfg, _, tcfg, tparams, _ = models
    return TEngine(tcfg, TCache(**_cache_kw(mode, kv_quant)),
                   TRuntime(**rt_kw), tparams, device="cpu",
                   sketch=_sketch(jcfg))


def engines(models, mode, kv_quant="int8", **rt_kw):
    """A JAX and a port engine on the same weights, sketch and settings."""
    jcfg, jparams = models[:2]
    je = JEngine(jcfg, JCache(**_cache_kw(mode, kv_quant)),
                 JRuntime(prefill_block_q=128, **rt_kw), jparams)
    return je, port_engine(models, mode, kv_quant, **rt_kw)


def compare(models, mode, **rt_kw):
    """Prefill logits within atol 1e-4 (+ rtol 1e-5) and greedy tokens
    equal; returns the port's prefill logits."""
    je, te = engines(models, mode, **rt_kw)
    ids = models[-1]
    jl, _ = je.prefill(ids)
    tl, _ = te.prefill(ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    jt, _ = je.generate(ids, gen_len=GEN)
    tt, _ = te.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, jt)
    return tl

"""The non-llama model families at engine level: the port against the JAX
package on the four shapes of ``tests/test_model_families.py``:

- Phi-style MHA with head_dim 24 (not a lane multiple);
- Qwen-style GQA with qkv bias;
- GLM-style partial interleaved RoPE with qkv bias;
- MHA with 16 KV heads and int8 stores.

Both packages get the same float32 numpy weights (biases included, carried
by ``from_jax_params``), the same prompt and JAX's low-rank sketch
(``Engine(sketch=...)``: with ``rank + 32 >= K*Dh`` the factors depend on
the sketch in f32). The port's full engine and its XLA-gather shadow engine
(``use_pallas=None``, the JAX default) must give the JAX engines' greedy
tokens, and the shadow engines the same cached chunk ids.
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

PROMPT, GEN = 256, 6

# (model shape, shadow cache settings, qkv bias) of each family, as in
# tests/test_model_families.py.
FAMILIES = {
    "phi-mha-dh24": (
        dict(name="toy-phi", num_heads=4, num_kv_heads=4, head_dim=24,
             hidden_size=96, intermediate_size=192),
        dict(sparse_budget=160, rank=4 * 24), False),
    "qwen-gqa-bias": (
        dict(name="toy-qwen", num_heads=4, num_kv_heads=2, head_dim=32,
             hidden_size=128, qkv_bias=True),
        dict(sparse_budget=160, rank=2 * 32), True),
    "glm-partial-interleaved": (
        dict(name="toy-glm", num_heads=4, num_kv_heads=2, head_dim=32,
             hidden_size=128, qkv_bias=True, rope_style="glm",
             rope_partial_dim=16),
        dict(sparse_budget=160, rank=2 * 32), True),
    "mha16-int8": (
        dict(name="toy-mha16", num_heads=16, num_kv_heads=16, head_dim=8,
             hidden_size=128),
        dict(sparse_budget=64, rank=32, kv_quant="int8"), False),
}


def _weights(jcfg, bias: bool, seed: int = 0):
    """float32 numpy weights N(0, 0.1) (norms near 1), a prompt."""
    rng = np.random.default_rng(seed)
    l, d = jcfg.num_layers, jcfg.hidden_size
    i, v = jcfg.intermediate_size, jcfg.vocab_size
    qkv = (jcfg.num_heads + 2 * jcfg.num_kv_heads) * jcfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    params = JModel(
        embed=w(v, d),
        layers=JLayer(
            attn_norm=1.0 + 0.1 * w(l, d), wqkv=w(l, d, qkv),
            bqkv=w(l, qkv) if bias else None, wo=w(l, jcfg.q_size, d),
            mlp_norm=1.0 + 0.1 * w(l, d), w_gate_up=w(l, d, 2 * i),
            w_down=w(l, i, d),
        ),
        final_norm=1.0 + 0.1 * w(d),
        lm_head=w(d, v),
    )
    ids = rng.integers(1, v, (1, PROMPT))
    return params, ids


@pytest.mark.parametrize("mode", ["full", "shadow"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_engine_matches_jax(family, mode):
    shape, shadow_kw, bias = FAMILIES[family]
    jcfg = j_toy(dtype=jnp.float32, **shape)
    tcfg = t_toy(dtype=torch.float32, **shape)
    np_params, ids = _weights(jcfg, bias)
    kw = dict(mode=mode, max_length=2 * PROMPT)
    if mode == "shadow":
        kw.update(outlier_chunks=4, **shadow_kw)
    je = JEngine(jcfg, JCache(**kw), JRuntime(prefill_block_q=64),
                 jax.tree.map(jnp.asarray, np_params))
    sketch = None
    if mode == "shadow":
        # lowrank_kv_factors draws its sketch from PRNGKey(7).
        d = jcfg.num_kv_heads * jcfg.head_dim
        omega = jax.random.normal(jax.random.PRNGKey(7),
                                  (d, min(d, kw["rank"] + 32)), jnp.float32)
        sketch = torch.from_numpy(np.array(omega))
    te = TEngine(tcfg, TCache(**kw), TRuntime(use_pallas=None),
                 from_jax_params(np_params, device="cpu"), device="cpu",
                 sketch=sketch)
    assert not te.use_kernel
    jt, _ = je.generate(ids, gen_len=GEN)
    tt, _ = te.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, jt)
    if mode == "shadow":
        np.testing.assert_array_equal(te._cache.cached_ids.numpy(),
                                      np.asarray(je._cache.cached_ids))

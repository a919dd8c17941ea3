"""Context checkpoints of the port (``utils/checkpoint.py``,
``Engine.save_state`` / ``load_state``), the matrix of
``tests/test_checkpoint.py``.

A context prefilled by one engine and saved after two greedy tokens
resumes in a fresh engine through ``generate(cont=True)`` with the tokens
of one uninterrupted ``generate``, exactly: for the fused refresh and the
XLA-gather branch (with and without the chunk-gather kernel), int8 and
unquantized stores, V on the device and in the host store, and across
placements. A layout or model mismatch raises; every field, its dtype and
the layout survive the round trip, right after a prefill and with per-slot
depths. Against the JAX package (unquantized stores: an int8 U differs
between two factorizations, ROADMAP.md §3 "int8 U across
factorizations"): JAX's save/load/resume and the port's give equal tokens.
Toy f32 model, N(0, 0.2) weights, rank 32 spanning the 64 key features (the
factors do not depend on a sketch).
"""

from __future__ import annotations


import numpy as np
import pytest

import torch

from shadowkv_tpu_torch.cache.shadow import ShadowCache
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import (from_jax_params,
                                              init_synthetic_params)
from shadowkv_tpu_torch.models.registry import toy_config
from shadowkv_tpu_torch.utils import checkpoint

PROMPT, BATCH = 256, 2
# decode path -> runtime settings
PATHS = {"fused": dict(use_pallas=True), "gather": dict(),
         "ring": dict(ring_gather=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these toy-sized ops gain nothing from more, and
    under the suite's parallel workers the spinning thread pools of every
    worker slow each small op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_weights():
    """Seeded numpy f32 weights of the JAX toy shape (N(0, 0.2))."""
    from shadowkv_tpu.core.layers import LayerParams, ModelParams
    from shadowkv_tpu.models.registry import toy_config as j_toy

    cfg = j_toy()
    rng = np.random.default_rng(0)
    l, d, i, v = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    return ModelParams(
        embed=w(v, d),
        layers=LayerParams(
            attn_norm=np.ones((l, d), np.float32), wqkv=w(l, d, qkv),
            bqkv=None, wo=w(l, cfg.q_size, d),
            mlp_norm=np.ones((l, d), np.float32), w_gate_up=w(l, d, 2 * i),
            w_down=w(l, i, d)),
        final_norm=np.ones((d,), np.float32),
        lm_head=w(d, v),
    )


def _cache_kw(mode, quant):
    return dict(mode=mode, max_length=512, sparse_budget=64, rank=32,
                outlier_chunks=4, kv_quant=quant)


def _engine(np_weights, mode="shadow", quant="none", path="gather",
            **cache_kw):
    cfg = toy_config(dtype=torch.float32)
    cc = CacheConfig(**{**_cache_kw(mode, quant), **cache_kw})
    return Engine(cfg, cc, RuntimeConfig(**PATHS[path]),
                  from_jax_params(np_weights, device="cpu"), device="cpu")


def _ids(seed, batch=BATCH):
    return np.random.RandomState(seed).randint(0, 512, (batch, PROMPT))


def _resume(np_weights, src, dst, path, seed=0):
    """(uninterrupted tokens, saved-and-resumed tokens)."""
    ids = _ids(seed)
    ref, _ = _engine(np_weights, *src).generate(ids, gen_len=10)
    a_eng = _engine(np_weights, *src)
    out_a, _ = a_eng.generate(ids, gen_len=2)
    a_eng.save_state(path)
    b_eng = _engine(np_weights, *dst)
    b_eng.load_state(path)
    out_b, _ = b_eng.generate(out_a[:, 1:], gen_len=8, cont=True)
    return ref, np.concatenate([out_a, out_b], axis=1)


@pytest.mark.parametrize("mode, quant, path", [
    ("shadow", "none", "gather"), ("shadow", "int8", "gather"),
    ("shadow", "none", "fused"), ("shadow", "int8", "fused"),
    ("shadow", "int8", "ring"), ("shadow_offload", "none", "fused"),
    ("shadow_offload", "int8", "fused"), ("shadow_offload", "int8", "ring"),
])
def test_roundtrip_resume(np_weights, tmp_path, mode, quant, path):
    run = (mode, quant, path)
    ref, got = _resume(np_weights, run, run, str(tmp_path / "ctx.npz"))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src, dst", [
    (("shadow", "int8", "fused"), ("shadow_offload", "int8", "fused")),
    (("shadow_offload", "none", "ring"), ("shadow", "none", "gather")),
    (("shadow", "none", "fused"), ("shadow_offload", "none", "ring")),
    (("shadow_offload", "int8", "fused"), ("shadow", "int8", "ring")),
], ids=lambda run: "-".join(run))
def test_cross_placement_load(np_weights, tmp_path, src, dst):
    """V saved on the device loads into the host store and back."""
    ref, got = _resume(np_weights, src, dst, str(tmp_path / "ctx.npz"),
                       seed=3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dst_kw, match", [
    (dict(quant="int8"), "does not match"),
    (dict(chunk_size=16), "does not match"),
    (dict(rank=16), "does not match"),
    (dict(gen_capacity=128), "does not match"),
    (dict(sparse_budget=128), "does not match"),
    (dict(max_length=128), "exceeds max_length"),
])
def test_layout_mismatch_raises(np_weights, tmp_path, dst_kw, match):
    eng = _engine(np_weights)
    eng.prefill(_ids(4, batch=1))
    path = str(tmp_path / "ctx.npz")
    eng.save_state(path)
    dst_kw = dict(dst_kw)
    quant = dst_kw.pop("quant", "none")
    other = _engine(np_weights, "shadow", quant, "gather", **dst_kw)
    with pytest.raises(ValueError, match=match):
        other.load_state(path)


def test_model_mismatch_and_full_cache_raise(np_weights, tmp_path):
    eng = _engine(np_weights)
    eng.prefill(_ids(4, batch=1))
    path = str(tmp_path / "ctx.npz")
    eng.save_state(path)
    cfg = toy_config(dtype=torch.float32, num_layers=3)
    other = Engine(cfg, CacheConfig(**_cache_kw("shadow", "none")),
                   RuntimeConfig(), init_synthetic_params(
                       cfg, torch.Generator().manual_seed(0)), device="cpu")
    with pytest.raises(ValueError, match="does not match this engine's model"):
        other.load_state(path)
    full = _engine(np_weights, "full")
    with pytest.raises(ValueError, match="shadow"):
        full.load_state(path)
    with pytest.raises(ValueError, match="prefilled"):
        _engine(np_weights).save_state(path)


@pytest.mark.parametrize("slots", [False, True])
def test_fields_dtypes_and_layout_survive(tmp_path, slots):
    """A bf16 model with int8 stores saved right after its prefill (or, with
    per-slot depths, after one step): every field bit-equal with its dtype,
    the layout, ``gen_len`` and the engine's host-side depths."""
    cfg = toy_config(dtype=torch.bfloat16)
    params = init_synthetic_params(cfg, torch.Generator().manual_seed(1))
    eng = Engine(cfg, CacheConfig(**_cache_kw("shadow", "int8")),
                 RuntimeConfig(use_pallas=True), params, device="cpu")
    eng.prefill(_ids(5))
    if slots:
        eng.use_slot_depths(eng._cache)
        eng.decode_step(eng._cache, torch.tensor([1, 2], dtype=torch.int32))
    path = str(tmp_path / "ctx.npz")
    eng.save_state(path)
    loaded = checkpoint.load_shadow_state(path, "cpu")
    src = eng._cache
    assert loaded.layout == src.layout
    for name in ShadowCache.FIELDS + ("gen_len",):
        a, b = getattr(loaded, name), getattr(src, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert src.k_buf.dtype == torch.bfloat16 and src.u.dtype == torch.int8
    other = Engine(cfg, CacheConfig(**_cache_kw("shadow_offload", "int8")),
                   RuntimeConfig(use_pallas=True), params, device="cpu")
    other.load_state(path)
    assert other._cache.v_on_host and torch.equal(other._cache.v_full,
                                                  src.v_full)
    np.testing.assert_array_equal(other._steps.depth, eng._steps.depth)


def test_resume_matches_jax(np_weights, tmp_path):
    """JAX's save -> load -> generate(cont=True) and the port's give equal
    tokens (unquantized stores, XLA-gather branch)."""
    import jax
    import jax.numpy as jnp

    from shadowkv_tpu.config import CacheConfig as JCache
    from shadowkv_tpu.config import RuntimeConfig as JRuntime
    from shadowkv_tpu.models.engine import Engine as JEngine
    from shadowkv_tpu.models.registry import toy_config as j_toy

    jparams = jax.tree.map(jnp.asarray, np_weights)

    def j_engine():
        return JEngine(j_toy(dtype=jnp.float32),
                       JCache(**_cache_kw("shadow", "none")),
                       JRuntime(prefill_block_q=64), jparams)

    ids = _ids(0)
    je = j_engine()
    ja, _ = je.generate(ids, gen_len=2)
    je.save_state(str(tmp_path / "jax.npz"))
    je2 = j_engine()
    je2.load_state(str(tmp_path / "jax.npz"))
    jb, _ = je2.generate(np.asarray(ja)[:, 1:], gen_len=8, cont=True)
    j_got = np.concatenate([np.asarray(ja), np.asarray(jb)], axis=1)
    run = ("shadow", "none", "gather")
    _, t_got = _resume(np_weights, run, run, str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(t_got, j_got)

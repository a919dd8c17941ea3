"""The layer-segmented offload prefill (``offload_prefill_segments``) in the
PyTorch port, against the JAX package on the CPU
(``tests/test_offload_segmented.py`` is the JAX side).

The whole batch runs in one call. JAX runs the layers in segments and
stages each segment's V rows on the device; the port's prefill already
writes each layer's V rows straight into the host store, so it runs the
ordinary prefill over the whole batch and records the store as sharded
over layers. Float32 toy model of the JAX test (4 layers, head_dim 32,
the JAX weights from ``PRNGKey(0)`` at scale 0.2, the JAX sketch), one
512-token prompt, ring gather:

- unquantized stores, 2 segments: greedy tokens and cached chunk ids equal
  JAX's segmented engine's, and the host store is bit-equal to the port's
  unsegmented offload engine's (the same tokens too);
- int8 stores, 4 segments: the port's segmented engine against its
  unsegmented offload engine and its HBM engine (tokens, ids, every store);
- the store is recorded as sharded over layers, and a slot admission is
  refused with JAX's message;
- the prefill of a two-row batch is one call whatever
  ``prefill_sub_batch`` asks, two calls without segments.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.config import RuntimeConfig as JRuntime
from shadowkv_tpu.models.engine import Engine as JEngine
from shadowkv_tpu.models.params import init_synthetic_params as j_init
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.config import RuntimeConfig as TRuntime
from shadowkv_tpu_torch.models.engine import Engine as TEngine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.models.registry import toy_config as t_toy
from test_torch_serving import _one_intra_op_thread  # noqa: F401

RANK = 32


@pytest.fixture(scope="module")
def toy():
    jcfg = j_toy(num_layers=4, dtype=jnp.float32)
    tcfg = t_toy(num_layers=4, dtype=torch.float32)
    jparams = j_init(jcfg, jax.random.PRNGKey(0), scale=0.2)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    d = jcfg.num_kv_heads * jcfg.head_dim
    omega = jax.random.normal(jax.random.PRNGKey(7), (d, min(d, RANK + 32)),
                              jnp.float32)
    ids = np.random.RandomState(3).randint(1, jcfg.vocab_size, (1, 512))
    return jcfg, jparams, tcfg, tparams, torch.from_numpy(np.array(omega)), ids


def _cc(mode, quant):
    return dict(mode=mode, max_length=512, sparse_budget=64, rank=RANK,
                outlier_chunks=4, gen_capacity=32, kv_quant=quant)


def _port(toy, mode, quant, segments=1):
    _, _, tcfg, tparams, omega, _ = toy
    return TEngine(tcfg, TCache(**_cc(mode, quant)), TRuntime(
        ring_gather=True, offload_prefill_segments=segments), tparams,
        device="cpu", sketch=omega)


def _run(eng, ids):
    toks, _ = eng.generate(ids, gen_len=8)
    return toks, eng._cache


def test_segmented_matches_jax_bf16(toy):
    jcfg, jparams, *_, ids = toy
    je = JEngine(jcfg, JCache(**_cc("shadow_offload", "none")), JRuntime(
        prefill_block_q=128, ring_gather=True, offload_prefill_segments=2),
        jparams)
    j_toks, _ = je.generate(ids, gen_len=8)
    seg = _port(toy, "shadow_offload", "none", 2)
    t_toks, t_cache = _run(seg, ids)
    np.testing.assert_array_equal(t_toks, j_toks)
    np.testing.assert_array_equal(t_cache.cached_ids.numpy(),
                                  np.asarray(je._cache.cached_ids))
    assert seg._host_axis == "layer" == je._host_axis
    assert t_cache.v_on_host and t_cache.v_full.device.type == "cpu"
    flat_toks, flat_cache = _run(_port(toy, "shadow_offload", "none"), ids)
    np.testing.assert_array_equal(t_toks, flat_toks)
    assert torch.equal(t_cache.v_full, flat_cache.v_full)


def test_segmented_int8_four_segments(toy):
    ids = toy[-1]
    seg = _port(toy, "shadow_offload", "int8", 4)
    t_toks, t_cache = _run(seg, ids)
    for mode in ("shadow_offload", "shadow"):
        toks, cache = _run(_port(toy, mode, "int8"), ids)
        np.testing.assert_array_equal(t_toks, toks)
        for name in ("cached_ids", "v_full", "v_scale", "u", "u_scale",
                     "k_buf", "v_buf"):
            assert torch.equal(getattr(t_cache, name), getattr(cache, name)), (
                mode, name)
    assert seg.kv_stats()["host_bytes"] == t_cache.v_full.numel()


def test_segmented_rejects_slot_admission(toy, tmp_path):
    """Admission into a layer-sharded store is refused; the same context
    saved and loaded again is a batch-sharded store, which admits."""
    ids = toy[-1]
    eng = _port(toy, "shadow_offload", "none", 2)
    eng.generate(ids, gen_len=2)
    with pytest.raises(ValueError, match="layer-sharded"):
        eng.admit_slot(eng._cache, ids[0], 0)
    path = str(tmp_path / "ctx.npz")
    eng.save_state(path)
    eng.load_state(path)
    assert eng._host_axis == "batch"
    lg, _ = eng.admit_slot(eng._cache, ids[0], 0)
    assert lg.shape == (1, 1, toy[2].vocab_size)


def test_segmented_prefill_is_one_call_over_the_batch(toy, monkeypatch):
    from shadowkv_tpu_torch.models import forward

    calls = []
    inner = forward.prefill_shadow_into

    def spy(model, params, cache, ids, *args, **kw):
        calls.append(ids.shape[0])
        return inner(model, params, cache, ids, *args, **kw)

    monkeypatch.setattr(forward, "prefill_shadow_into", spy)
    _, _, tcfg, tparams, omega, ids = toy
    two = np.concatenate([ids, ids[:, ::-1]])
    for segments, expect in ((2, [2]), (1, [1, 1])):
        eng = TEngine(tcfg, TCache(**_cc("shadow_offload", "none")),
                      TRuntime(ring_gather=True, prefill_sub_batch=1,
                               offload_prefill_segments=segments),
                      tparams, device="cpu", sketch=omega)
        calls.clear()
        logits, _ = eng.prefill(two)
        assert calls == expect and logits.shape[0] == 2
        assert eng._host_axis == ("layer" if segments > 1 else "batch")


def test_segment_count_must_divide_layers(toy):
    with pytest.raises(ValueError, match="divide"):
        _port(toy, "shadow_offload", "int8", 3)
    with pytest.raises(ValueError, match="ring_gather"):
        TEngine(toy[2], TCache(**_cc("shadow_offload", "none")),
                TRuntime(offload_prefill_segments=2), toy[3], device="cpu")

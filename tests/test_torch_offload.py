"""The host-offloaded V store (``mode="shadow_offload"``) of the PyTorch
port on the CPU.

The port's offload engine, with the fused refresh (``use_pallas=True``) and
with the ring gather (``ring_gather=True``), against the JAX package's HBM
engine with the same decode strategy, on the float32 toy model of
``test_torch_engine.py`` (same weights, prompt and sketch). The JAX package's
own offload engines run the Pallas kernels in interpret mode and its tests
mark them slow; ``tests/test_offload.py`` shows that they give the HBM
engine's tokens, so the fast HBM engine is the reference here. Checks as in
``test_torch_engine.py``: greedy tokens and cached chunk ids equal, compact
buffers within 5 % of their largest entry on int8 stores.

On a CPU engine the V store is a plain CPU tensor (pinned only when the
engine runs on the card), so these tests run the same code as the card:
the store is allocated apart from the device cache, prefill writes it, and
``kv_stats`` counts it as host bytes. The configuration rules that the JAX
engine asserts raise here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine
from test_torch_engine import GEN, PROMPT, RANK, _compare_decode, _engines, models  # noqa: F401

STRATEGIES = {"fused": dict(use_pallas=True), "ring": dict(ring_gather=True)}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_offload_engine_matches_jax_hbm_engine(models, strategy):
    je, te = _engines(models, rt_kw=STRATEGIES[strategy], mode="shadow",
                      t_cache_kw=dict(mode="shadow_offload"),
                      kv_quant="int8")
    assert te.v_on_host and te.use_kernel == (strategy == "fused")
    _compare_decode(je, te, models[-1], "int8")


def test_offload_bf16_store_matches_jax_hbm_engine(models):
    """An unquantized offloaded store through the fused refresh."""
    je, te = _engines(models, rt_kw=dict(use_pallas=True), mode="shadow",
                      t_cache_kw=dict(mode="shadow_offload"),
                      kv_quant="none")
    _compare_decode(je, te, models[-1], "none")


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_offload_store_is_host_memory(models, strategy):
    """The V store is its own CPU tensor, counted as host bytes; the device
    bytes of the offload cache are the HBM cache's less that store; the
    tokens and cached ids equal the HBM engine's of the same strategy."""
    _, _, tcfg, tparams, ids = models
    kw = dict(max_length=PROMPT + 32, sparse_budget=128, rank=RANK,
              chunk_size=16, outlier_chunks=4, gen_capacity=32,
              kv_quant="int8")
    rt = RuntimeConfig(prefill_sub_batch=1, **STRATEGIES[strategy])
    out = {}
    for mode in ("shadow", "shadow_offload"):
        eng = Engine(tcfg, CacheConfig(mode=mode, **kw), rt, tparams,
                     device="cpu")
        toks, _ = eng.generate(ids, gen_len=GEN)
        out[mode] = (toks, eng._cache, eng.kv_stats())
    (t_hbm, c_hbm, s_hbm), (t_off, c_off, s_off) = out["shadow"], out["shadow_offload"]
    np.testing.assert_array_equal(t_off, t_hbm)
    np.testing.assert_array_equal(c_off.cached_ids.numpy(), c_hbm.cached_ids.numpy())
    assert torch.equal(c_off.v_full, c_hbm.v_full)  # same bytes, other place
    assert c_off.v_on_host and not c_hbm.v_on_host
    assert c_off.v_full.device.type == "cpu"
    store = c_off.v_full.numel() * c_off.v_full.element_size()
    assert "v_full" not in s_off["bytes_by_field"]
    assert s_off["host_bytes"] == store and s_hbm["host_bytes"] == 0
    assert s_off["device_bytes"] == s_hbm["device_bytes"] - store


_CONFIG_CASES = [
    (dict(kv_quant="int8"), dict(), ValueError),
    (dict(kv_quant="int8"), dict(use_pallas=False), ValueError),
    # the HostVStore path (bf16 store, neither kernel): served
    (dict(kv_quant="none"), dict(), None),
    (dict(kv_quant="int8"), dict(use_pallas=True, ring_gather=True),
     ValueError),
    # the layer-segmented offload prefill on the ring path: served
    (dict(kv_quant="int8"),
     dict(ring_gather=True, offload_prefill_segments=2), None),
    (dict(kv_quant="int8"), dict(use_pallas="auto"), ValueError),
]
# The ids name the error these cases raised while their paths were not
# ported yet ("NotImplementedError"), so each case keeps its test id.
_CONFIG_IDS = ["cache_kw0-rt_kw0-ValueError", "cache_kw1-rt_kw1-ValueError",
               "cache_kw2-rt_kw2-NotImplementedError",
               "cache_kw3-rt_kw3-ValueError",
               "cache_kw4-rt_kw4-NotImplementedError",
               "cache_kw5-rt_kw5-ValueError"]


@pytest.mark.parametrize("cache_kw, rt_kw, exc", _CONFIG_CASES,
                         ids=_CONFIG_IDS)
def test_offload_config_errors(cache_kw, rt_kw, exc):
    """JAX's asserts raise ValueError (an int8 offloaded store needs a
    decode kernel; use_pallas and ring_gather exclude each other; 'auto'
    serves the 'shadow' mode only); the HostVStore path and the segmented
    offload prefill are served (``exc`` None)."""
    cc = CacheConfig(mode="shadow_offload", max_length=64, **cache_kw)
    if exc is None:
        RuntimeConfig(**rt_kw).check_served(cc)
        return
    with pytest.raises(exc):
        RuntimeConfig(**rt_kw).check_served(cc)

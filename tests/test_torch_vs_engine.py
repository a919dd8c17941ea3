"""The sparse prefill engines: the port's Engine with
``prefill_pattern="vs"`` (``vs_impl`` tile and walk, a uniform per-head
table and a per-layer table) against the JAX package's Engine, on a
float32 toy model (head_dim 128, hidden 512, 4 heads / 2 KV heads, 2
layers) with the same numpy weights, prompt and low-rank sketch: on the
full cache, and for the per-layer table also on a shadow cache (decoded
through the XLA-gather branch). Shadow prefill of the walk and stream
patterns is held to the full one's logits exactly. On the CPU JAX runs its MInference oracles (``use_kernel=False``),
the port its kernels' plain versions. Checks: greedy tokens equal; prefill logits within
atol 1e-4 (+ rtol 1e-5: f32 sums in another order, as the dense engine
tests)."""

from __future__ import annotations

import pytest

import torch

from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.config import RuntimeConfig as TRuntime
from shadowkv_tpu_torch.kernels import prefill_attention, vs_sparse, vs_tile
from shadowkv_tpu_torch.models.engine import Engine as TEngine
from torch_toy import PROMPT, compare, models  # noqa: F401 (fixture)


# Sizes well below the 512-token prompt, so the patterns are sparse.
VS = dict(prefill_pattern="vs", vs_vertical_size=64, vs_slash_size=128,
          vs_block=64, vs_tile=128, stream_sink=32, stream_window=128)
ROW = (("vertical_and_slash", 64, 128), "stream_llm", "dense",
       ("vertical_and_slash", 40, 100))
LAYERS = (ROW, ("dense", ("vertical_and_slash", 100, 60), "stream_llm",
                ("vertical_and_slash", 30, 50)))


@pytest.mark.parametrize("impl", ["tile", "walk"])
def test_vs_engine_matches_jax(models, impl):
    """A uniform mixed per-head table (vertical_and_slash, stream_llm,
    dense) through both executions of the patterns (full cache)."""
    compare(models, "full", vs_impl=impl, minference_patterns=ROW, **VS)


@pytest.mark.parametrize("mode", ["full", "shadow"])
def test_vs_engine_per_layer_table_matches_jax(models, mode):
    """A per-layer table through the tile path: the port runs each layer's
    row, JAX its traced per-layer patterns; in shadow mode the greedy
    tokens also hold the shadow cache built after the sparse prefill."""
    compare(models, mode, minference_layer_patterns=LAYERS, **VS)


@pytest.mark.parametrize("rt_kw", [
    dict(VS, vs_impl="walk", minference_patterns=ROW),
    dict(prefill_pattern="stream", stream_window=128, stream_sink=32),
], ids=["vs-walk", "stream"])
def test_shadow_prefill_attends_as_full(models, rt_kw):
    """The shadow prefill layer runs the same sparse attention as the full
    one (the cache mode changes only what a layer stores), so the prefill
    logits are equal."""
    tcfg, tparams, ids = models[2], models[3], models[-1]
    logits = [
        TEngine(tcfg, TCache(mode=mode, max_length=PROMPT + 32,
                             sparse_budget=128, rank=64, chunk_size=16,
                             outlier_chunks=4),
                TRuntime(**rt_kw), tparams, device="cpu").prefill(ids)[0]
        for mode in ("full", "shadow")
    ]
    torch.testing.assert_close(logits[1], logits[0], atol=0, rtol=0)


def test_vs_engine_default_patterns_are_sparse(models):
    """All heads vertical_and_slash (the default table) at 64 verticals and
    50 slashes (the nearest 50 distances: bands 0 and 1 of 8) through the
    tile path: JAX's tokens, and logits that differ from dense prefill's."""
    dense = TEngine(models[2], TCache(max_length=PROMPT + 32), TRuntime(),
                    models[3], device="cpu").prefill(models[-1])[0]
    tl = compare(models, "full", **dict(VS, vs_slash_size=50))
    assert float((tl - dense).abs().max()) > 1e-3
    for fn in (vs_tile.vs_tile_attention, vs_sparse.vs_sparse_attention,
               prefill_attention.causal_prefill_splash):
        assert fn.launches == 0  # the CPU path launches no kernel


def test_vs_settings_are_checked(models):
    tcfg, tparams = models[2], models[3]
    cc = TCache(max_length=64)
    with pytest.raises(ValueError, match="vs_impl"):
        TEngine(tcfg, cc, TRuntime(prefill_pattern="vs", vs_impl="grid"),
                tparams, device="cpu")
    with pytest.raises(ValueError, match="block_sparse"):
        TEngine(tcfg, cc, TRuntime(
            prefill_pattern="vs",
            minference_layer_patterns=(ROW, ("block_sparse",) * 4)),
            tparams, device="cpu")
    with pytest.raises(ValueError, match="heads"):
        TEngine(tcfg, cc, TRuntime(prefill_pattern="vs",
                                   minference_patterns=ROW[:2]),
                tparams, device="cpu")


@pytest.mark.parametrize("impl", ["tile", "walk"])
def test_vs_sim_engine_matches_jax(models, monkeypatch, impl):
    """``vs_sim="clustered"`` (the benchmark-only score simulation) with
    JAX's draws handed to the port (each layer salts its draws with its
    index): JAX's prefill logits and greedy tokens."""
    from shadowkv_tpu_torch.core import minference as tmi
    from test_torch_minference import jax_sim_draws

    monkeypatch.setattr(tmi, "sim_vs_draws", jax_sim_draws)
    compare(models, "full", vs_impl=impl, vs_sim="clustered",
            minference_patterns=ROW, **VS)


def test_vs_sim_engine_runs(models):
    """With the port's own draws: a shadow engine prefills through the
    simulated patterns and decodes; the simulation changes the prefill
    (50 slashes, inside the forced nearest 100, so the verticals differ)."""
    tcfg, tparams, ids = models[2], models[3], models[-1]
    out = {}
    for sim in (None, "clustered"):
        eng = TEngine(tcfg, TCache(mode="shadow", max_length=PROMPT + 32,
                                   sparse_budget=128, rank=32, chunk_size=16,
                                   outlier_chunks=4, gen_capacity=32),
                      TRuntime(use_pallas=True, vs_sim=sim,
                               **dict(VS, vs_slash_size=50)), tparams,
                      device="cpu")
        logits, _ = eng.prefill(ids)
        toks, _ = eng.generate(ids, gen_len=4)
        assert toks.shape == (ids.shape[0], 4) and torch.isfinite(logits).all()
        out[sim] = logits
    assert float((out["clustered"] - out[None]).abs().max()) > 1e-4

"""Continuous batching in the PyTorch port (``shadowkv_tpu_torch/serving.py``)
on the CPU: the non-mesh cases of ``tests/test_serving.py``, on the float32
toy model of ``tests/torch_toy.py`` (same numpy weights and low-rank sketch
as the JAX package, rank 160, int8 stores, chunk 16, gen_capacity 32).

The load-bearing property is the JAX test's: a request served through the
batcher gives exactly the greedy tokens of its run alone (attention is per
sequence; an admission into the live cache disturbs no other slot). Each
case is held to the port's isolated ``generate`` runs; the chunk-3 fused
case is also held to the JAX batcher (its Pallas kernel in interpret
mode): the same tokens for every uid and the same ``ServeStats`` counters.
That case keeps its stores unquantized: the low-rank basis is unique only
up to a rotation (only U·SV is), so the two packages' factorizations (and
the port's own under another CPU thread count) round half of the int8 U
entries to neighbouring values, and on this stream one such difference
flips a chunk selection at a score near-tie (a gap of 5e-4 of the
score, the stream's smallest; uid 2's tokens then part at its step 2).
Other prompt seeds give JAX's tokens with int8 too (ROADMAP §3).
Unquantized U carries only the f32 rounding of U·SV.
Offload runs with the fused refresh and with the ring gather here; the
HostVStore (io_callback) path is served against JAX's batcher in
``test_torch_offload_host.py``; the mesh cases have no counterpart in the
port.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu.serving import ContinuousBatcher as JBatcher
from shadowkv_tpu.serving import Request as JRequest
from shadowkv_tpu_torch.serving import ContinuousBatcher, Request
from torch_toy import PROMPT, engines, models, port_engine  # noqa: F401

GEN_LENS = [6, 9, 4, 7, 5]
BRANCHES = {"fused": dict(use_pallas=True), "xla-gather": dict(use_pallas=None)}
COUNTERS = ("admissions", "chunks", "decode_steps", "completed_requests",
            "completed_tokens", "forced_tokens", "context_hits",
            "context_prefills")
_ISOLATED: dict = {}  # (settings, seed, request, gen_len) -> tokens


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread per worker (see test_torch_decode_chunk.py):
    the toy's many small ops run ~20x slower oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(models, seed: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        1, models[2].vocab_size, (n, PROMPT))


def _requests(prompts, gen_lens, cls=Request):
    return [cls(uid=i, input_ids=prompts[i], gen_len=g)
            for i, g in enumerate(gen_lens)]


def _isolated(models, mode, rt_kw, prompts, seed, i, gen_len):
    """Request i run alone through the port's ``generate`` (batch 1)."""
    key = (mode, tuple(sorted(rt_kw.items())), seed, i, gen_len)
    if key not in _ISOLATED:
        eng = port_engine(models, mode, **rt_kw)
        _ISOLATED[key] = eng.generate(prompts[i][None], gen_len=gen_len)[0][0]
    return _ISOLATED[key]


def _serve(models, mode, rt_kw, prompts, gen_lens, slots, **cb_kw):
    eng = port_engine(models, mode, **rt_kw)
    cb = ContinuousBatcher(eng, slots=slots, **cb_kw)
    return cb.run(_requests(prompts, gen_lens)) + (eng,)


def _assert_isolated(models, mode, rt_kw, prompts, seed, gen_lens, results):
    for i, g in enumerate(gen_lens):
        want = _isolated(models, mode, rt_kw, prompts, seed, i, g)
        np.testing.assert_array_equal(
            results[i], want, err_msg=f"request {i} diverged from its "
            "isolated run")


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("chunk", [1, 3])
def test_continuous_batching_matches_isolated_runs(models, chunk, branch):
    """chunk 1 is per-step dispatch; chunk 3 (odd, below every gen_len)
    has mid-chunk finishes and chunk-boundary admissions. Every decode
    chunk after the first replays the same step buffers (one path)."""
    rt_kw = BRANCHES[branch]
    prompts = _prompts(models, 7, len(GEN_LENS))
    results, stats, eng = _serve(models, "shadow", rt_kw, prompts, GEN_LENS,
                                 2, steps_per_dispatch=chunk)
    assert stats.completed_requests == len(GEN_LENS)
    assert stats.admissions == len(GEN_LENS) - 2
    assert stats.completed_tokens == sum(GEN_LENS)
    assert stats.decode_steps == stats.chunks * chunk
    assert eng._cache.gen_len.shape == (2,)
    _assert_isolated(models, "shadow", rt_kw, prompts, 7, GEN_LENS, results)


def test_chunk3_fused_matches_jax_batcher(models):
    """The JAX batcher and the port's on the same stream (fused refresh,
    chunk 3): the same tokens for every uid and the same counters."""
    je, te = engines(models, "shadow", kv_quant="none", use_pallas=True)
    prompts = _prompts(models, 7, len(GEN_LENS))
    j_res, j_stats = JBatcher(je, slots=2, steps_per_dispatch=3).run(
        _requests(prompts, GEN_LENS, JRequest))
    t_res, t_stats = ContinuousBatcher(te, slots=2, steps_per_dispatch=3).run(
        _requests(prompts, GEN_LENS))
    assert sorted(t_res) == sorted(j_res)
    for uid in j_res:
        np.testing.assert_array_equal(t_res[uid], j_res[uid],
                                      err_msg=f"uid {uid}")
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(j_stats, name), name


def test_continuous_batching_single_slot_queue(models):
    """Degenerate capacity-1 case: pure sequential serving."""
    prompts = _prompts(models, 8, 2)
    rt_kw = dict(use_pallas=True)
    results, stats, _ = _serve(models, "shadow", rt_kw, prompts, [5, 5], 1)
    assert stats.completed_requests == 2 and stats.admissions == 1
    _assert_isolated(models, "shadow", rt_kw, prompts, 8, [5, 5], results)


def test_idle_slot_drain(models):
    """Queue shorter than slots: idle slots must not corrupt the live one
    or overflow the gen region while it drains (the chunk is the whole gen
    region, 31 steps, so the idle-slot clamp and the per-slot rows both
    hold at the region's end)."""
    prompts = _prompts(models, 9, 3)
    gen_lens = [3, 30, 3]
    rt_kw = dict(use_pallas=True)
    results, stats, eng = _serve(models, "shadow", rt_kw, prompts, gen_lens,
                                 3)
    assert stats.completed_requests == 3
    assert stats.decode_steps == 31 and stats.chunks == 1
    want = _isolated(models, "shadow", rt_kw, prompts, 9, 1, 30)
    np.testing.assert_array_equal(results[1], want)
    assert int(eng._cache.gen_len.max()) <= 32


@pytest.mark.parametrize("strategy", ["fused", "ring"])
def test_continuous_batching_offload(models, strategy):
    """V in host memory: admissions prefill straight into the slot's rows
    of the host store and reproduce each request's isolated offload run.
    The initial prefill runs one sequence per sub-batch."""
    rt_kw = dict(prefill_sub_batch=1, **(
        dict(use_pallas=True) if strategy == "fused" else
        dict(ring_gather=True)))
    prompts = _prompts(models, 13, 4)
    gen_lens = [5, 8, 4, 6]
    results, stats, eng = _serve(models, "shadow_offload", rt_kw, prompts,
                                 gen_lens, 2)
    assert eng._cache.v_on_host
    assert stats.completed_requests == 4 and stats.admissions == 2
    _assert_isolated(models, "shadow_offload", rt_kw, prompts, 13, gen_lens,
                     results)


def test_full_mode_rejected(models):
    with pytest.raises(ValueError, match="shadow"):
        ContinuousBatcher(port_engine(models, "full"), slots=2)


def test_gen_overflow_rejected(models):
    """gen_len past gen_capacity is refused before anything runs."""
    prompts = _prompts(models, 10, 2)
    eng = port_engine(models, "shadow", use_pallas=True)
    with pytest.raises(ValueError, match="gen_capacity"):
        ContinuousBatcher(eng, slots=2).run(_requests(prompts, [4, 33]))
    assert eng._cache is None


def test_rebound_depth_raises(models):
    """A per-slot depth vector is written in place only; a step on a cache
    whose ``gen_len`` was rebound raises instead of replaying a graph that
    reads the dead buffer. Per-slot depths come before the first step."""
    eng = port_engine(models, "shadow", use_pallas=True)
    prompts = _prompts(models, 11, 2)
    logits, cache = eng.prefill(prompts)
    tok = logits[:, -1].argmax(-1).int()
    eng.use_slot_depths(cache)
    depth = cache.gen_len
    eng.reset_slot_depth(0, 4)
    eng.reset_slot_depth(1, 4)
    zeros = np.zeros((2, 2), np.int32)
    tok, _ = eng.decode_chunk(cache, tok, zeros, zeros.astype(bool))
    assert cache.gen_len is depth and depth.tolist() == [2, 2]
    eng.clamp_idle_depths([True, False], 29)
    assert cache.gen_len is depth and depth.tolist() == [2, 2]
    eng.clamp_idle_depths([True, False], 30)
    assert depth.tolist() == [2, 1]
    cache.gen_len = depth.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        eng.decode_chunk(cache, tok, zeros, zeros.astype(bool))
    cache.gen_len = depth
    eng.decode_chunk(cache, tok, zeros, zeros.astype(bool))
    with pytest.raises(RuntimeError, match="before the first"):
        eng.use_slot_depths(cache)

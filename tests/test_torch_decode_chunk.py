"""The compiled decode step of the PyTorch port on the CPU, against the JAX
engine on the float32 toy model of ``test_torch_engine.py`` (same weights,
prompt and sketch).

- ``Engine.decode_chunk`` (k teacher-forced steps, one host read) against
  JAX's ``decode_chunk_jit`` (``eng._decode_chunk``), greedy, k = 4, two
  chunks in a row, forced tokens at some (step, row): the fused refresh,
  the XLA-gather branch, the ring gather, and the fused refresh over an
  offloaded V store (against JAX's HBM engine, as ``test_torch_offload.py``
  does). Tokens, every step's tokens, cached ids and ``gen_len`` are equal.
- The cache's position (``ShadowCache.gen_len``, ``FullCache.length``) is a
  0-d int32 tensor on the engine's device that a step advances in place,
  and steps started at a non-zero position give JAX's logits (the RoPE
  rows at ``kv_len``, the gen row written at ``sparse_end + gen_len``).
- ``decode_step`` and ``generate`` run the step function the card captures
  on the same buffers: equal to the eager ``_decode`` + greedy sampling.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.models import forward as jforward
from shadowkv_tpu_torch.core.sampling import sample_token
from test_torch_engine import BATCH, _engines, models  # noqa: F401

K = 4
FORCED_AT = ((1, 0), (2, 1))  # (step, batch row) fed a forced token

# name -> (JAX reference run, the port's cache mode)
STRATEGIES = {
    "fused": ("fused", "shadow"),
    "xla-gather": ("xla-gather", "shadow"),
    "ring": ("ring", "shadow"),
    "offload-fused": ("fused", "shadow_offload"),
}
RUNTIME = {"fused": dict(use_pallas=True), "xla-gather": dict(use_pallas=None),
           "ring": dict(ring_gather=True)}
_JAX_RUNS: dict = {}  # JAX reference run -> its results, computed once


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Run this file's torch work on the calling thread: under the suite's
    parallel workers, eight intra-op threads per worker oversubscribe the
    cores and make the toy model's many small ops ~20x slower. The tests
    pass with one thread and with eight; the setting only saves time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forced(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    val = rng.integers(1, vocab, (K, BATCH)).astype(np.int32)
    on = np.zeros((K, BATCH), bool)
    for t, b in FORCED_AT:
        on[t, b] = True
    return val, on


def _jax_run(je, ids, vocab):
    """JAX's first greedy token, then two chunks: their (tokens,
    every step's tokens), and the final cached ids and gen_len."""
    jl, jc = je.prefill(ids)
    key = jax.random.PRNGKey(0)
    jtok = je._sample(jl, key, 0.0, 50, 0.9)
    first, chunks = np.asarray(jtok), []
    for chunk in range(2):
        val, on = _forced(vocab, chunk)
        jtok, jc, key, jall = je._decode_chunk(
            je.params, jc, jtok, key, jnp.asarray(val), jnp.asarray(on),
            0.0, 50, 0.9)
        chunks.append((np.asarray(jtok), np.asarray(jall)))
    return first, chunks, np.asarray(jc.cached_ids), int(jc.gen_len)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_decode_chunk_matches_jax(models, strategy):
    ref, t_mode = STRATEGIES[strategy]
    je, te = _engines(models, rt_kw=RUNTIME[ref], mode="shadow",
                      t_cache_kw=dict(mode=t_mode), kv_quant="int8")
    ids, vocab = models[-1], models[2].vocab_size
    if ref not in _JAX_RUNS:
        _JAX_RUNS[ref] = _jax_run(je, ids, vocab)
    first, chunks, j_ids, j_gen = _JAX_RUNS[ref]
    tl, tc = te.prefill(ids)
    ttok = sample_token(tl[:, -1])
    np.testing.assert_array_equal(ttok.numpy(), first)
    for chunk, (jtok, jall) in enumerate(chunks):
        val, on = _forced(vocab, chunk)
        ttok, tall = te.decode_chunk(tc, ttok, torch.from_numpy(val),
                                     torch.from_numpy(on))
        np.testing.assert_array_equal(tall.numpy(), jall)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        for t, b in FORCED_AT:
            assert int(tall[t, b]) == val[t, b]
    np.testing.assert_array_equal(tc.cached_ids.numpy(), j_ids)
    assert int(tc.gen_len) == j_gen == 2 * K


def _jax_step(je):
    """JAX's decode forward (logits and the new cache), jitted once."""
    if je.is_shadow:
        fn = functools.partial(jforward.decode_shadow, je.model)
    else:
        fn = functools.partial(jforward.decode_full, je.model)
    return jax.jit(lambda params, cache, tokens: fn(
        params, cache, tokens, je.cos_table, je.sin_table))


@pytest.mark.parametrize("mode", ["shadow", "full"])
def test_decode_position_is_a_device_tensor(models, mode):
    """Three steps fed the same tokens on both packages, the last two at a
    non-zero position: the position tensor is the same object after each
    step and counts the steps; the logits of every step agree with JAX's
    within the prefill logits' bound (atol 1e-4 + rtol 1e-5) on the full
    cache, and within 1e-3 of the largest logit on an unquantized shadow
    cache (whose rebuilt keys come from the two packages' f32 low-rank
    factors, within 0.1 % of each other: test_torch_engine.py)."""
    je, te = _engines(models, rt_kw=dict(use_pallas=None), mode=mode,
                      kv_quant="none")
    ids = models[-1]
    _, jc = je.prefill(ids)
    _, tc = te.prefill(ids)
    pos = tc.gen_len if mode == "shadow" else tc.length
    start = 0 if mode == "shadow" else ids.shape[1]
    assert isinstance(pos, torch.Tensor) and pos.dim() == 0
    assert pos.dtype == torch.int32 and pos.device == te.device
    feed = np.random.default_rng(5).integers(
        1, models[2].vocab_size, (3, BATCH)).astype(np.int32)
    step_fn = _jax_step(je)
    for step in range(3):
        jlog, jc = step_fn(je.params, jc, jnp.asarray(feed[step][:, None]))
        tlog = te._decode(tc, torch.from_numpy(feed[step])[:, None])
        assert (tc.gen_len if mode == "shadow" else tc.length) is pos
        assert int(pos) == start + step + 1
        jlog = np.asarray(jlog)
        if mode == "full":
            np.testing.assert_allclose(tlog.numpy(), jlog, atol=1e-4,
                                       rtol=1e-5)
        else:
            err = np.abs(tlog.numpy() - jlog).max()
            assert err <= 1e-3 * np.abs(jlog).max(), (step, err)
    if mode == "shadow":
        assert int(tc.gen_len) == int(jc.gen_len)
        np.testing.assert_array_equal(tc.cached_ids.numpy(),
                                      np.asarray(jc.cached_ids))
    else:
        assert int(tc.length) == int(jc.length)


@pytest.mark.parametrize("mode", ["shadow", "full"])
def test_compiled_step_equals_eager_step(models, mode):
    """``decode_step`` (the step the card captures, run eagerly on its
    buffers on the CPU) against ``_decode`` + greedy sampling on a copy of
    the cache: the same tokens, logits and cache state; ``generate`` and
    ``decode_chunk`` continue the same greedy stream."""
    _, te = _engines(models, rt_kw=dict(use_pallas=True), mode=mode,
                     kv_quant="int8")
    ids = models[-1]
    logits, cache = te.prefill(ids)
    tok = sample_token(logits[:, -1])
    if mode == "shadow":
        copy = dataclasses.replace(
            cache, k_buf=cache.k_buf.clone(), v_buf=cache.v_buf.clone(),
            cached_ids=cache.cached_ids.clone(), gen_len=cache.gen_len.clone())
    else:
        copy = dataclasses.replace(cache, k=cache.k.clone(),
                                   v=cache.v.clone(),
                                   length=cache.length.clone())
    stream = [tok]
    for _ in range(3):
        nxt, step_logits = te.decode_step(cache, stream[-1])
        ref = te._decode(copy, stream[-1][:, None])[:, -1]
        np.testing.assert_array_equal(step_logits.numpy(), ref.numpy())
        np.testing.assert_array_equal(nxt.numpy(), sample_token(ref).numpy())
        stream.append(nxt.clone())
    names = ("k_buf", "v_buf", "cached_ids", "gen_len") if mode == "shadow" \
        else ("k", "v", "length")
    for name in names:
        assert torch.equal(getattr(cache, name), getattr(copy, name)), name
    full, _ = te.generate(ids, gen_len=7)
    np.testing.assert_array_equal(full[:, :4], torch.stack(stream, 1).numpy())
    _, cache = te.prefill(ids)
    zeros = torch.zeros(6, BATCH, dtype=torch.int32)
    last, toks = te.decode_chunk(cache, torch.from_numpy(full[:, 0]), zeros,
                                 zeros.bool())
    np.testing.assert_array_equal(toks.T.numpy(), full[:, 1:])
    np.testing.assert_array_equal(last.numpy(), full[:, -1])

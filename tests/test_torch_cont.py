"""Multi-turn continuation and the per-slot pieces of continuous batching in
the PyTorch port, against the JAX package on the CPU (float32 toy model of
``tests/torch_toy.py``: same weights, prompt and low-rank sketch).

- ``generate(cont=True, cont_chunk=4)`` for a 7-token second turn (one
  4-token decode step, then three 1-token steps through the compiled step's
  forced rows): tokens and cached chunk ids equal JAX's.
- ``decode_attention_hm`` with a [B] ``kv_len`` (per-slot depths 3 and 0)
  against JAX's, atol 1e-5.
- ``_extract_slot`` then ``_merge_slots_v`` (or ``_merge_slots`` and the
  host rows) moves slot 0 into slot 1 of a live cache: every field of the
  two slots is equal afterwards, the host V rows too on offload.
- A decode step over a [B] ``gen_len`` whose slots sit at one depth gives
  the 0-d step's logits (atol 1e-6) and writes the same cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.core.attention import decode_attention_hm as j_attn
from shadowkv_tpu_torch.cache.shadow import ShadowCache
from shadowkv_tpu_torch.core.attention import decode_attention_hm
from test_torch_serving import _one_intra_op_thread  # noqa: F401
from torch_toy import engines, models, port_engine  # noqa: F401


def test_cont_generate_matches_jax(models):
    """Turn one: prefill + 3 tokens; turn two: 7 tokens teacher-forced in
    steps of 4, 1, 1, 1, then 5 generated tokens."""
    je, te = engines(models, "shadow", use_pallas=True)
    ids = models[-1]
    turn2 = np.random.RandomState(3).randint(
        1, models[2].vocab_size, (ids.shape[0], 7))
    j_first, t_first = (eng.generate(ids, gen_len=3)[0] for eng in (je, te))
    jt, _ = je.generate(turn2, gen_len=5, cont=True, cont_chunk=4)
    tt, stats = te.generate(turn2, gen_len=5, cont=True, cont_chunk=4)
    np.testing.assert_array_equal(t_first, j_first)
    np.testing.assert_array_equal(tt, jt)
    assert tt.shape == (ids.shape[0], 5) and stats.decode_tokens == 2 * 4
    np.testing.assert_array_equal(te._cache.cached_ids.numpy(),
                                  np.asarray(je._cache.cached_ids))
    assert int(te._cache.gen_len) == int(je._cache.gen_len) == 2 + 7 + 4
    # the next turn would overflow the 32-row gen region
    with pytest.raises(ValueError, match="gen_capacity"):
        te.generate(turn2, gen_len=14, cont=True)


def test_cont_needs_a_prior_call(models):
    with pytest.raises(ValueError, match="prior"):
        port_engine(models, "shadow", use_pallas=True).generate(
            models[-1], gen_len=2, cont=True)


def test_decode_attention_per_slot_depths_matches_jax():
    rng = np.random.default_rng(4)
    b, s_new, h, kh, t, dh = 2, 2, 4, 2, 24, 16
    q = rng.standard_normal((b, s_new, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, kh, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, kh, t, dh)).astype(np.float32)
    kv_len = np.array([3, 0], np.int32) + 10 + s_new  # depths 3 and 0
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kv_len)))
    got = decode_attention_hm(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # each slot alone at its own 0-d length
    for i in range(b):
        alone = decode_attention_hm(
            torch.from_numpy(q[i:i + 1]), torch.from_numpy(k[i:i + 1]),
            torch.from_numpy(v[i:i + 1]), torch.tensor(int(kv_len[i])))
        np.testing.assert_allclose(got[i:i + 1].numpy(), alone.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["shadow", "shadow_offload"])
def test_extract_merge_round_trip(models, mode):
    eng = port_engine(models, mode, use_pallas=True)
    ids = models[-1]
    eng.generate(ids, gen_len=3)  # slot state past the prefill
    cache = eng._cache
    small = eng._extract_slot(cache, 0)
    assert small.k_buf.shape[1] == 1 and small.gen_len.shape == ()
    if mode == "shadow_offload":
        assert small.v_full.shape[3] == 0  # the rows live host-side
        rows = eng.host_slot_rows(0)
        eng._merge_slots(cache, small, 1)
        eng.set_host_slot_rows(rows, 1)
    else:
        eng._merge_slots_v(cache, small, 1)
    for name in ShadowCache.FIELDS:
        t = getattr(cache, name)
        if t is not None:
            assert torch.equal(t[:, 0], t[:, 1]), name
    assert cache.v_full.device.type == "cpu"
    if mode == "shadow_offload":
        assert eng.host_slot_rows(1).shape == rows.shape
        with pytest.raises(ValueError):
            port_engine(models, "shadow").host_slot_rows(0)


def test_per_slot_step_equals_scalar_step(models):
    """Two copies of one prefilled cache, one with a 0-d gen_len and one
    with a [B] gen_len at the same depths: one decode step of the same
    tokens gives the same logits, gen rows and cached ids."""
    eng = port_engine(models, "shadow", use_pallas=True)
    logits, cache = eng.prefill(models[-1])
    tok = logits[:, -1].argmax(-1).int()[:, None]
    eng._decode(cache, tok)  # depth 1 on both slots
    per_slot = dataclasses.replace(
        cache, k_buf=cache.k_buf.clone(), v_buf=cache.v_buf.clone(),
        cached_ids=cache.cached_ids.clone(),
        gen_len=cache.gen_len.expand(2).clone())
    scalar = eng._forward_step(cache, tok)
    vector = eng._forward_step(per_slot, tok)
    np.testing.assert_allclose(vector.numpy(), scalar.numpy(), atol=1e-6)
    assert per_slot.gen_len.tolist() == [2, 2] and int(cache.gen_len) == 2
    for name in ("k_buf", "v_buf", "cached_ids"):
        assert torch.equal(getattr(per_slot, name), getattr(cache, name)), name

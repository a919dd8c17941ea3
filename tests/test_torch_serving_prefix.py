"""Shared-prefix admissions in the port's ContinuousBatcher on the CPU: the
cases of ``tests/test_serving_prefix.py``, on the float32 toy model of
``tests/torch_toy.py``.

Requests with one ``context_id`` share their first ``context_len`` prompt
tokens; the context is prefilled once and snapshotted
(``Engine._extract_slot``, plus ``host_slot_rows`` with V in host memory),
later admissions restore the snapshot (``_merge_slots_v``, or
``_merge_slots`` + ``set_host_slot_rows``) and teacher-force their suffix
through the decode chunks' forced rows. The oracle is the engine's
multi-turn path, ``generate(prefix)`` then ``generate(suffix, cont=True)``:
the same math, so the greedy tokens must be equal. The HBM case is also
held to the JAX batcher (tokens for every uid and the ``ServeStats``
counters) on unquantized stores, for the reason given in
``test_torch_serving.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu.serving import ContinuousBatcher as JBatcher
from shadowkv_tpu.serving import Request as JRequest
from shadowkv_tpu_torch.serving import ContinuousBatcher, Request
from test_torch_serving import COUNTERS, _one_intra_op_thread  # noqa: F401
from torch_toy import PROMPT, engines, models, port_engine  # noqa: F401

GEN = 6
SUF = 3
MODES = {
    "hbm": ("shadow", dict(use_pallas=True)),
    "offload-fused": ("shadow_offload",
                      dict(use_pallas=True, prefill_sub_batch=1)),
    "offload-ring": ("shadow_offload",
                     dict(ring_gather=True, prefill_sub_batch=1)),
}
_ORACLE: dict = {}


def _tokens(models, seed, n, length=PROMPT):
    return [np.random.RandomState(seed + i).randint(
        1, models[2].vocab_size, length).astype(np.int32) for i in range(n)]


def _requests(prefixes, suffixes, ctx_ids, cls=Request):
    return [cls(uid=i, input_ids=np.concatenate([prefixes[c], suf]),
                gen_len=GEN, context_id=c, context_len=PROMPT)
            for i, (c, suf) in enumerate(zip(ctx_ids, suffixes))]


def _oracle(models, mode, rt_kw, prefix, suffix, kv_quant="int8"):
    """generate(prefix) then generate(suffix, cont=True) on a batch of one:
    the multi-turn continuation (the prefix prefill, the suffix through
    decode steps)."""
    key = (mode, tuple(sorted(rt_kw.items())), kv_quant, prefix.tobytes(),
           suffix.tobytes())
    if key not in _ORACLE:
        eng = port_engine(models, mode, kv_quant, **rt_kw)
        eng.generate(prefix[None], gen_len=1)
        out, _ = eng.generate(suffix[None], gen_len=GEN, cont=True)
        _ORACLE[key] = out[0]
    return _ORACLE[key]


@pytest.mark.parametrize("case", sorted(MODES))
def test_prefix_cache_matches_multiturn_oracle(models, case):
    mode, rt_kw = MODES[case]
    prefix = _tokens(models, 0, 1)[0]
    suffixes = _tokens(models, 100, 4, SUF)
    eng = port_engine(models, mode, **rt_kw)
    results, stats = ContinuousBatcher(eng, slots=2).run(
        _requests([prefix], suffixes, [0] * 4))
    assert stats.completed_requests == 4
    # slots 0/1 prefill the context (the initial batch); later admissions
    # restore the snapshot
    assert stats.context_hits == 2 and stats.context_prefills == 1
    assert stats.forced_tokens == 4 * SUF
    for i, suf in enumerate(suffixes):
        want = _oracle(models, mode, rt_kw, prefix, suf)
        np.testing.assert_array_equal(results[i], want, err_msg=f"request {i}")


def test_prefix_cache_matches_jax_batcher(models):
    """The HBM case on the JAX batcher and the port's: the same tokens for
    every uid and the same counters."""
    je, te = engines(models, "shadow", kv_quant="none", use_pallas=True)
    prefix = _tokens(models, 0, 1)[0]
    suffixes = _tokens(models, 100, 4, SUF)
    j_res, j_stats = JBatcher(je, slots=2).run(
        _requests([prefix], suffixes, [0] * 4, JRequest))
    t_res, t_stats = ContinuousBatcher(te, slots=2).run(
        _requests([prefix], suffixes, [0] * 4))
    assert sorted(t_res) == sorted(j_res)
    for uid in j_res:
        np.testing.assert_array_equal(t_res[uid], j_res[uid],
                                      err_msg=f"uid {uid}")
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(j_stats, name), name


def test_distinct_contexts_and_eviction(models):
    """ctx 0, 1, 0, 1 on one slot: with room for one snapshot every context
    change evicts the other (no hits); with room for two the repeats are
    hits, and the tokens are the same either way."""
    prefixes = _tokens(models, 10, 2)
    suffixes = _tokens(models, 200, 4, SUF)
    ctx = [0, 1, 0, 1]
    rt_kw = dict(use_pallas=True)
    runs = []
    for max_contexts, hits in ((1, 0), (2, 2)):
        eng = port_engine(models, "shadow", **rt_kw)
        res, stats = ContinuousBatcher(eng, slots=1,
                                       max_contexts=max_contexts).run(
            _requests(prefixes, suffixes, ctx))
        assert stats.completed_requests == 4
        assert stats.context_hits == hits
        runs.append(res)
    for i in range(4):
        want = _oracle(models, "shadow", rt_kw, prefixes[ctx[i]], suffixes[i])
        np.testing.assert_array_equal(runs[0][i], want)
        np.testing.assert_array_equal(runs[1][i], runs[0][i])


def test_mixed_context_and_plain_requests_rejected_on_length(models):
    """A plain request whose prompt length differs from the context
    requests' prefill length is refused (one static layout)."""
    prefix = _tokens(models, 20, 1)[0]
    reqs = [
        Request(uid=0, input_ids=np.concatenate([prefix, prefix[:SUF]]),
                gen_len=GEN, context_id=3, context_len=PROMPT),
        Request(uid=1, input_ids=prefix[:PROMPT - 8], gen_len=GEN),
    ]
    eng = port_engine(models, "shadow", use_pallas=True)
    with pytest.raises(ValueError, match="prefill length"):
        ContinuousBatcher(eng, slots=2).run(reqs)


def test_context_id_reuse_with_different_prefix_rejected(models):
    p1, p2 = _tokens(models, 30, 2)
    suf = _tokens(models, 300, 1, SUF)[0]
    reqs = [Request(uid=i, input_ids=np.concatenate([p, suf]), gen_len=GEN,
                    context_id=5, context_len=PROMPT)
            for i, p in enumerate((p1, p2))]
    eng = port_engine(models, "shadow", use_pallas=True)
    with pytest.raises(ValueError, match="different prefix"):
        ContinuousBatcher(eng, slots=1).run(reqs)
    assert torch.is_tensor(eng._cache.gen_len)

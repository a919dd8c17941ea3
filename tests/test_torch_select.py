"""The selection kernel's launch plan and algorithm on the CPU
(``kernels/select.py``, ``csrc/select.cu``).

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it to
its plain version there). Here: the plan's cluster sizes and shared-memory
spill at the decode cells' shapes, tp shards and a 1M context; the wrapper's
plain version on CPU tensors, which is ``score_and_select`` then the forced
ids then ``assign_slots_stable``; and numpy models of the kernel's two
algorithms, held to the plain functions: the radix top-S over the probs'
bits with its tie rule, and the slot assignment from bitmaps (prefix
popcount of the incoming ids, vacated slots by rank)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.core import quant as tq
from shadowkv_tpu_torch.core import selection as tsel
from shadowkv_tpu_torch.kernels import select as ksel

H100 = dict(sms=132, smem_max=232448)

# (B, K, G * Q, C, S, head_dim, int8) -> (cluster, scores spilled)
PLAN_CASES = {
    "glm4 decode": ((8, 4, 8, 4088, 256, 128, False), (4, False)),
    "yi offload, int8": ((8, 4, 8, 4088, 256, 128, True), (4, False)),
    "k-exaone decode": ((8, 8, 8, 4088, 256, 128, False), (2, False)),
    "tp2 shard": ((8, 2, 8, 4088, 256, 128, False), (8, False)),
    "tp4 shard": ((8, 1, 8, 4088, 256, 128, False), (8, False)),
    "glm4 at 1M": ((8, 4, 8, 131064, 256, 128, False), (4, True)),
    "1M, one row": ((1, 4, 8, 131064, 2048, 128, True), (8, True)),
    "G*Q 32": ((8, 4, 32, 4088, 256, 128, False), (4, False)),
    "toy": ((2, 2, 2, 24, 8, 32, False), (1, False)),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan(name):
    """N = min(8, SMs // (B K), tiles // 4); each range a multiple of 64
    chunks covering C; the scores in shared memory unless they outgrow it,
    then a scratch slice per CTA; the whole layout within the card's
    limit."""
    args, (cluster, spilled) = PLAN_CASES[name]
    b, kh, rows, c, s, dh, int8 = args
    p = ksel.plan(*args, **H100)
    assert p.cluster == cluster
    assert p.per % ksel.TILE == 0 and p.cluster * p.per >= c
    assert (p.cluster - 1) * p.per < c  # no CTA without chunks
    assert (p.scratch_floats > 0) == spilled
    if spilled:
        rows_pad = -(-rows // 8) * 8
        assert p.scratch_floats == p.cluster * b * kh * rows_pad * p.sc_stride
    assert p.smem_bytes <= H100["smem_max"]
    offs = p[5:17]
    assert list(offs) == sorted(offs) and all(o % 16 == 0 for o in offs)


def test_plan_refuses_what_does_not_fit():
    """A select set whose assignment scans outgrow shared memory raises."""
    with pytest.raises(ValueError, match="shared memory"):
        ksel.plan(1, 1, 8, 2**22, 2**16, 128, False, **H100)


def _case(seed, b=2, kh=2, g=3, qn=2, c=200, dh=32, s=16, int8=False):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, kh, g, qn, dh),
                                             dtype=np.float32))
    lm = torch.from_numpy(rng.standard_normal((b, kh, c, dh),
                                              dtype=np.float32))
    mask = torch.from_numpy(rng.random((b, kh, c)) > 0.1)
    prev = torch.from_numpy(np.stack([rng.permutation(c)[:s]
                                      for _ in range(b * kh)])
                            .reshape(b, kh, s).astype(np.int32))
    scale = None
    if int8:
        lm, scale = tq.quantize_rows(lm)
    return q, lm, mask, prev, scale


@pytest.mark.parametrize("int8", [False, True])
def test_wrapper_takes_the_plain_version_on_cpu(int8):
    q, lm, mask, prev, scale = _case(1, int8=int8)
    before = ksel.select_slots.launches
    out = ksel.select_slots(q, lm, mask, prev, 16, landmark_scale=scale)
    ref = ksel.select_slots_plain(q, lm, mask, prev, 16, landmark_scale=scale)
    assert ksel.select_slots.launches == before
    for a, b_ in zip(out, ref):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("hysteresis", [0.0, 0.3])
@pytest.mark.parametrize("int8", [False, True])
def test_plain_is_select_then_forced_then_assign(int8, hysteresis, forced):
    """``select_slots_plain`` is ``score_and_select`` (hysteresis on the
    previous ids), the forced ids in place of its set, then
    ``assign_slots_stable``."""
    q, lm, mask, prev, scale = _case(2, int8=int8)
    s = prev.shape[-1]
    ids = tsel.score_and_select(q, lm, mask, s, landmark_scale=scale,
                                resident_ids=prev if hysteresis else None,
                                hysteresis=hysteresis)
    f = None
    if forced:
        f = torch.arange(7, 7 + s, dtype=torch.int32)
        ids = f.expand_as(ids)
    want = tsel.assign_slots_stable(prev, ids)
    got = ksel.select_slots_plain(q, lm, mask, prev, s, landmark_scale=scale,
                                  hysteresis=hysteresis, forced_ids=f)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    if hysteresis and not forced:  # the boost reaches the choice
        plain = tsel.assign_slots_stable(prev, tsel.score_and_select(
            q, lm, mask, s, landmark_scale=scale))
        assert int(got.stay_count.sum()) >= int(plain.stay_count.sum())


# -- numpy models of the kernel's algorithms ---------------------------------

def radix_top_model(probs: np.ndarray, mask: np.ndarray, s: int) -> np.ndarray:
    """The kernel's chosen set of one row: key = the f32 prob's bits + 1, 0
    at an outlier; 4 passes of 256-bin histograms from the top byte find the
    S-th key T; keys above T are chosen, then keys equal to T in ascending
    chunk id until S. Returns a bool mask over the chunks."""
    bits = probs.astype(np.float32).view(np.uint32).astype(np.int64)
    keys = np.where(mask, bits + 1, 0)
    prefix, need = 0, s
    for p in range(4):
        shift = 24 - 8 * p
        cand = keys[(keys >> (shift + 8)) == (prefix >> (shift + 8))]
        hist = np.bincount((cand >> shift) & 255, minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= need:
                break
            above += hist[d]
        need -= above
        prefix |= d << shift
    chosen = keys > prefix
    chosen[np.flatnonzero(keys == prefix)[:need]] = True
    return chosen


def bitmap_assign_model(prev: np.ndarray, chosen: np.ndarray):
    """The kernel's assignment of one row from bitmaps: stay where the new
    set holds the slot's id; the incoming ids (new bits not in the previous
    ids' bitmap) ranked by an exclusive prefix popcount over 32-bit words,
    each word's bits in ascending order; vacated slots ranked by an
    exclusive scan in slot order; rank r's id goes to rank r's slot."""
    c = chosen.shape[0]
    words = -(-c // 32)

    def pack(bits):
        out = np.zeros(words * 32, dtype=np.uint64)
        out[:c] = bits
        return (out.reshape(words, 32) << np.arange(32, dtype=np.uint64)).sum(
            -1).astype(np.uint64)

    valid = (prev >= 0) & (prev < c)
    prev_bits = np.zeros(c, dtype=bool)
    prev_bits[prev[valid]] = True
    nbm, pbm = pack(chosen), pack(prev_bits)
    stay = valid & chosen[np.clip(prev, 0, c - 1)]
    vac_rank = np.cumsum(~stay) - (~stay)  # exclusive scan
    vac_slot = np.empty(len(prev), dtype=np.int64)
    vac_slot[vac_rank[~stay]] = np.flatnonzero(~stay)
    n_vac = int((~stay).sum())
    inc = nbm & ~pbm
    pops = np.array([bin(int(w)).count("1") for w in inc])
    base = np.cumsum(pops) - pops
    slot_ids = np.where(stay, prev, 2**30).astype(np.int32)
    for w in range(words):
        r, bits = int(base[w]), int(inc[w])
        while bits:
            i = (bits & -bits).bit_length() - 1
            bits &= bits - 1
            if r < n_vac:
                slot_ids[vac_slot[r]] = 32 * w + i
            r += 1
    return slot_ids, stay, int(stay.sum())


def _assign_cases():
    rng = np.random.default_rng(3)
    c, s = 300, 24
    prev = rng.permutation(c)[:s].astype(np.int32)
    others = np.setdiff1d(np.arange(c), prev)
    half = np.concatenate([prev[rng.permutation(s)[:s // 2]],
                           rng.permutation(others)[:s - s // 2]])
    yield "random half kept", prev, half
    yield "every id stays", prev, rng.permutation(prev)
    yield "none stays", prev, rng.permutation(others)[:s]
    yield "all incoming, one run", np.arange(100, 100 + s, dtype=np.int32), \
        np.arange(s, dtype=np.int32)
    yield ("ids at word edges", np.arange(0, 32 * s, 32, dtype=np.int32) % c,
           np.arange(31, 31 + 32 * s, 32, dtype=np.int32) % c)
    yield "a fresh cache (prev all 0)", np.zeros(s, dtype=np.int32), \
        rng.permutation(c)[:s].astype(np.int32)
    yield "a fresh cache, 0 chosen", np.zeros(s, dtype=np.int32), \
        np.concatenate([[0], rng.permutation(np.arange(1, c))[:s - 1]]) \
        .astype(np.int32)
    for k in range(4):
        p = rng.permutation(c)[:s].astype(np.int32)
        n_new = rng.integers(0, s + 1)
        new = p.copy()
        fresh = np.setdiff1d(rng.permutation(c), p)[:n_new]
        new[rng.permutation(s)[:n_new]] = fresh
        yield f"random {k}", p, rng.permutation(new)


ASSIGN_CASES = {name: (p, n) for name, p, n in _assign_cases()}


@pytest.mark.parametrize("name", sorted(ASSIGN_CASES))
def test_bitmap_assignment_equals_assign_slots_stable(name):
    prev, new = ASSIGN_CASES[name]
    c = 300
    chosen = np.zeros(c, dtype=bool)
    chosen[new] = True
    slot_ids, stay, count = bitmap_assign_model(prev, chosen)
    ref = tsel.assign_slots_stable(torch.from_numpy(prev)[None],
                                   torch.from_numpy(new)[None])
    np.testing.assert_array_equal(slot_ids, ref.slot_ids[0].numpy())
    np.testing.assert_array_equal(stay, ref.stay_mask[0].numpy())
    assert count == int(ref.stay_count[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_top_equals_topk_on_distinct_probs(seed):
    """Distinct probs: the radix select chooses torch.topk's set, outliers
    (prob 0) included only when fewer unmasked chunks remain."""
    rng = np.random.default_rng(seed)
    c, s = 1000, 64
    probs = rng.random(c).astype(np.float32) ** 8
    mask = rng.random(c) > 0.2
    probs = np.where(mask, probs, 0.0).astype(np.float32)
    got = radix_top_model(probs, mask, s)
    want = torch.topk(torch.from_numpy(probs), s).indices.numpy()
    assert got.sum() == s
    assert set(np.flatnonzero(got)) == set(want)


def test_radix_top_takes_ties_in_ascending_id():
    """Equal probs at the S-th value are taken from the lowest chunk id up;
    everything above them is taken."""
    c, s = 500, 40
    probs = np.full(c, 0.25, dtype=np.float32)
    probs[[7, 300, 450]] = 0.5
    got = radix_top_model(probs, np.ones(c, dtype=bool), s)
    want = np.zeros(c, dtype=bool)
    want[[7, 300, 450]] = True
    want[[i for i in range(c) if i not in (7, 300, 450)][:s - 3]] = True
    np.testing.assert_array_equal(got, want)


def test_radix_top_never_takes_an_outlier_over_an_equal_prob():
    """Probs that underflowed to 0 tie with the outliers' 0: the unmasked
    chunks are taken first, whatever their ids."""
    c, s = 200, 20
    probs = np.zeros(c, dtype=np.float32)
    probs[150:160] = 1e-3
    mask = np.ones(c, dtype=bool)
    mask[:100] = False  # the low ids are outliers
    got = radix_top_model(probs, mask, s)
    assert got[150:160].all() and got.sum() == s
    assert not got[:100].any()
    assert np.flatnonzero(got[100:])[:10].tolist() == list(range(10))

"""The port's MInference module (``core/minference.py``) and the plain
versions of kernels F and G against the JAX package's functions, at f32 on
the CPU with numpy-seeded inputs.

Tolerances: estimation scores within rtol 1e-5 / atol 1e-7 (f32 softmax
and diagonal sums in another order), and the top-k index sets exactly, at
seeds whose k-th gap the test shows to exceed that tolerance; flags and
metadata bit-equal; attention outputs within atol = rtol = 1e-5 (f32 sums
in another order; the port is blockwise over queries, the JAX oracles hold
[BH, S, S]). The dispatcher tests hand both sides JAX's estimated scores,
so a near-tie in the estimate cannot change the selection."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.core import minference as jmi
from shadowkv_tpu.kernels.vs_tile import vs_tok_attention_reference as j_tok
from shadowkv_tpu_torch.core import minference as tmi
from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(seed, b, s, h, kh, dh=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, dh), (b, s, kh, dh), (b, s, kh, dh)))


def _assert_top_k_decided(scores, k, tol):
    """The k-th and (k+1)-th largest finite scores of every row differ by
    more than ``tol``, so rounding cannot swap the selection."""
    srt = np.sort(scores, axis=-1)[..., ::-1]
    kth, nxt = srt[..., k - 1], srt[..., k]
    finite = np.isfinite(kth)
    assert (np.abs(kth - nxt)[finite] > tol).all()


@pytest.mark.parametrize("seed, s, vsize, ssize", [(0, 512, 64, 160),
                                                   (3, 300, 40, 120)])
def test_estimation_matches_jax(seed, s, vsize, ssize):
    q, k, _ = _qkv(seed, 2, s, 4, 2)
    jv, js = jmi.estimate_vertical_slash(jnp.asarray(q), jnp.asarray(k))
    tv, ts = tmi.estimate_vertical_slash(_t(q), _t(k))
    for j, t in ((jv, tv), (js, ts)):
        j = np.asarray(j)
        np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t.numpy()[fin], j[fin], rtol=1e-5, atol=1e-7)
    gap_tol = 1e-5 * float(np.abs(np.asarray(js)[np.isfinite(js)]).max())
    _assert_top_k_decided(np.asarray(jv), vsize, gap_tol)
    _assert_top_k_decided(np.asarray(js), ssize, gap_tol)
    for j, t, size in ((jv, tv, vsize), (js, ts, ssize)):
        _, j_idx = jax.lax.top_k(j, size)
        np.testing.assert_array_equal(
            np.sort(tmi.top_k(t, size).numpy(), -1), np.sort(j_idx, -1))


def test_top_k_breaks_ties_like_jax():
    """Integer scores with many ties: the stable sort keeps JAX's order."""
    x = np.random.default_rng(1).integers(0, 4, (6, 200)).astype(np.float32)
    x[:, :30] = np.inf
    for k in (30, 64, 137):
        np.testing.assert_array_equal(tmi.top_k(_t(x), k).numpy(),
                                      np.asarray(jax.lax.top_k(x, k)[1]))


def _meta_equal(t, j):
    for f in ("col_ids", "col_cnt", "col_flag", "diag_ids", "diag_cnt"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("n_blk, block", [(8, 64), (5, 128)])
def test_flags_and_meta_bit_equal(n_blk, block):
    rng = np.random.default_rng(n_blk)
    s = n_blk * block
    v_idx = rng.integers(0, s + 3 * block, (6, 40)).astype(np.int32)
    s_idx = rng.integers(0, s + 3 * block, (6, 60)).astype(np.int32)
    v_idx[:, :5] = v_idx[:, 5:10]  # duplicates fold
    for jf, tf in zip(jmi.vs_flags(jnp.asarray(v_idx), jnp.asarray(s_idx),
                                   n_blk, block),
                      tmi.vs_flags(_t(v_idx), _t(s_idx), n_blk, block)):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(
        tmi.diag_flags_from_slash(_t(s_idx), n_blk, block).numpy(),
        np.asarray(jmi.diag_flags_from_slash(jnp.asarray(s_idx), n_blk, block)))
    _meta_equal(tmi.build_vs_meta(_t(v_idx), _t(s_idx), s - 5, block),
                jmi.build_vs_meta(jnp.asarray(v_idx), jnp.asarray(s_idx),
                                  s - 5, block))
    col = (rng.random((6, n_blk)) < 0.4).astype(np.int32)
    diag = (rng.random((6, n_blk)) < 0.4).astype(np.int32)
    tm = tmi.meta_from_flags(_t(col), _t(diag))
    jm = jmi.meta_from_flags(jnp.asarray(col), jnp.asarray(diag))
    _meta_equal(tm, jm)
    np.testing.assert_array_equal(tmi.expand_block_mask(tm, n_blk).numpy(),
                                  np.asarray(jmi.expand_block_mask(jm, n_blk)))
    # scores with ties through the top-k
    vert = rng.integers(0, 5, (6, s)).astype(np.float32)
    sl = rng.integers(0, 5, (6, s)).astype(np.float32)
    _meta_equal(
        tmi.vs_meta_from_scores(_t(vert), _t(sl), 45, 70, s - 9, block, s),
        jmi.vs_meta_from_scores(jnp.asarray(vert), jnp.asarray(sl), 45, 70,
                                s - 9, block, s))


@pytest.mark.parametrize("sink, window", [(64, 256), (100, 130), (0, 64)])
def test_stream_meta_is_the_sink_window_mask(sink, window):
    """stream_meta equals JAX's, and its blocks cover exactly the blocks
    that hold a pair of the token mask causal & (k < sink | q - k < window)
    (block granularity: whole blocks of the band are on)."""
    s, block = 1024, 64
    n_blk = s // block
    tm = tmi.stream_meta(3, s, block, sink, window)
    _meta_equal(tm, jmi.stream_meta(3, s, block, sink, window))
    pos = np.arange(s)
    tok = (pos[None] <= pos[:, None]) & (
        (pos[None] < sink) | (pos[:, None] - pos[None] < window))
    blocks = tok.reshape(n_blk, block, n_blk, block).any(axis=(1, 3))
    got = tmi.expand_block_mask(tm, n_blk).numpy()
    assert (got >= blocks[None]).all()  # a superset of the token mask
    qb, kb = np.meshgrid(np.arange(n_blk), np.arange(n_blk), indexing="ij")
    want = (kb <= qb) & ((kb * block < sink) | ((qb - kb) * block < window + block))
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))


def test_block_sparse_attention_matches_jax():
    q, k, v = _qkv(5, 2, 200, 4, 2)  # ragged: 200 = 3 * 64 + 8
    kw = dict(topk_blocks=2, block=64)
    j = jmi.block_sparse_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    t = tmi.block_sparse_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # a head subset with its own kv heads
    j = jmi.block_sparse_attention(jnp.asarray(q[:, :, 1:3]), jnp.asarray(k),
                                   jnp.asarray(v), head_kv=[1, 0], **kw)
    t = tmi.block_sparse_attention(_t(q[:, :, 1:3]), _t(k), _t(v),
                                   head_kv=[1, 0], **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _flat_inputs(seed, bh=4, bkv=2, s=384, dh=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, s, dh)).astype(np.float32)
    k = rng.standard_normal((bkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((bkv, s, dh)).astype(np.float32)
    kv_map = np.array([0, 0, 1, 1], np.int32)
    return q, k, v, kv_map, rng


@pytest.mark.parametrize("block, seq_len", [(64, 384), (128, 301)])
def test_walk_plain_matches_jax_oracle(block, seq_len):
    """Kernel G's plain version (blockwise, also what the wrapper takes on
    the CPU) against JAX's ``vs_attention_reference``."""
    q, k, v, kv_map, rng = _flat_inputs(block)
    n_blk = q.shape[1] // block
    col = (rng.random((4, n_blk)) < 0.4).astype(np.int32)
    diag = (rng.random((4, n_blk)) < 0.4).astype(np.int32)
    diag[:, 0] = 1
    jm = jmi.meta_from_flags(jnp.asarray(col), jnp.asarray(diag))
    j = jmi.vs_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jm, jnp.asarray(kv_map),
                                   block, seq_len=seq_len)
    tm = tmi.meta_from_flags(_t(col), _t(diag))
    t = vs_sparse.vs_sparse_attention(
        _t(q), _t(k), _t(v), tm.col_ids, tm.col_cnt, tm.col_flag,
        tm.diag_ids, tm.diag_cnt, _t(kv_map), block=block,
        scale=q.shape[-1] ** -0.5, seq_len=seq_len)
    assert vs_sparse.vs_sparse_attention.launches == 0  # CUDA launches only
    np.testing.assert_allclose(t.numpy()[:, :seq_len],
                               np.asarray(j)[:, :seq_len], **TOL)


@pytest.mark.parametrize("block, seq_len", [(64, 384), (128, 301)])
def test_tile_plain_matches_jax_oracle(block, seq_len):
    """Kernel F's plain version against JAX's
    ``vs_tok_attention_reference``, with duplicate verticals, verticals
    past seq_len and pads."""
    q, k, v, kv_map, rng = _flat_inputs(block + 1)
    s = q.shape[1]
    n_blk = s // block
    diag = (rng.random((4, n_blk)) < 0.3).astype(np.int32)
    diag[:, 0] = 1
    v_idx = rng.integers(0, s, (4, 50)).astype(np.int32)
    v_idx[:, 10:20] = v_idx[:, :10]
    v_idx[:, -5:] = 2 * s
    kw = dict(block=block, scale=q.shape[-1] ** -0.5, seq_len=seq_len)
    j = j_tok(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              jnp.asarray(v_idx), jnp.asarray(diag), jnp.asarray(kv_map), **kw)
    t = vs_tile.vs_tile_attention(_t(q), _t(k), _t(v), _t(v_idx), _t(diag),
                                  _t(kv_map), **kw)
    assert vs_tile.vs_tile_attention.launches == 0
    np.testing.assert_allclose(t.numpy()[:, :seq_len],
                               np.asarray(j)[:, :seq_len], **TOL)


def test_prepare_verticals_dedups_and_sorts():
    k = torch.randn(2, 128, 8)
    v_idx = torch.tensor([[5, 5, 90, 3, 300, 100], [7, 1, 1, 1, 2, 120]],
                         dtype=torch.int32)
    k_sel, _, pos = vs_tile.prepare_verticals(k, k, v_idx,
                                              torch.tensor([0, 1]), 100)
    pad = 256
    assert pos.shape == (2, vs_tile.TILE)
    assert pos[0, :4].tolist() == [3, 5, 90, pad] and (pos[0, 3:] == pad).all()
    assert pos[1, :4].tolist() == [1, 2, 7, pad]
    assert ((pos < 100).sum(1)).tolist() == [3, 3]
    assert torch.equal(pos, vs_tile.vertical_positions(v_idx, 128, 100))
    assert torch.equal(k_sel[1, 2], k[1, 7])


@pytest.fixture
def jax_scores(monkeypatch):
    """Both sides estimate with JAX's function (so their selections are
    the same); the port gets the scores as torch tensors."""
    def est(q, k, scale=None, last_q=tmi.LAST_Q, head_kv=None):
        jv, js = jmi.estimate_vertical_slash(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), scale, last_q,
            head_kv)
        return _t(jv), _t(js)

    monkeypatch.setattr(tmi, "estimate_vertical_slash", est)


MIXED = [("vertical_and_slash", 64, 128), "stream_llm", "dense",
         ("vertical_and_slash", 40, 70), ("block_sparse", 0, 0),
         ("vertical_and_slash", 64, 128), "stream_llm", "dense"]


@pytest.mark.parametrize("impl, s", [("walk", 448), ("tile", 300)])
def test_dispatch_mixed_kinds_matches_jax(jax_scores, impl, s):
    q, k, v = _qkv(11, 2, s, 8, 2)
    kw = dict(patterns=MIXED, block=64, stream_sink=32, stream_window=96,
              bs_topk_blocks=2)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if impl == "walk":
        j = jmi.minference_prefill(*jargs, use_kernel=False, **kw)
        t = tmi.minference_prefill(_t(q), _t(k), _t(v), **kw)
    else:
        j = jmi.minference_prefill_tile(*jargs, use_kernel=False, tile=128,
                                        **kw)
        t = tmi.minference_prefill_tile(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


PER_LAYER = (
    (("vertical_and_slash", 64, 128), "stream_llm", "dense",
     ("vertical_and_slash", 40, 70)),
    ("dense", ("vertical_and_slash", 100, 60), ("vertical_and_slash", 30, 50),
     "stream_llm"),
)


@pytest.mark.parametrize("impl", ["walk", "tile"])
def test_per_layer_rows_match_jax_dynamic(jax_scores, impl):
    """The port runs a per-layer table through the static functions with
    the layer's row; JAX through its traced-pattern functions."""
    kinds, vs, ss, v_cap, s_cap = jmi.patterns_to_arrays(PER_LAYER, 4, 2,
                                                         1000, 6144)
    kw = dict(block=64, stream_sink=32, stream_window=96)
    for layer in range(2):
        q, k, v = _qkv(20 + layer, 1, 384, 4, 2)
        jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(kinds[layer]), jnp.asarray(vs[layer]),
                 jnp.asarray(ss[layer]))
        if impl == "walk":
            j = jmi.minference_prefill_dynamic(
                *jargs, v_cap=v_cap, s_cap=s_cap, use_kernel=False, **kw)
            t = tmi.minference_prefill(_t(q), _t(k), _t(v),
                                       patterns=PER_LAYER[layer], **kw)
        else:
            j = jmi.minference_prefill_dynamic_tile(
                *jargs, v_cap=v_cap, s_cap=s_cap, use_kernel=False, tile=128,
                **kw)
            t = tmi.minference_prefill_tile(_t(q), _t(k), _t(v),
                                            patterns=PER_LAYER[layer], **kw)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_patterns_to_arrays_matches_jax():
    for got, want in zip(tmi.patterns_to_arrays(PER_LAYER, 4, 2, 1000, 6144),
                         jmi.patterns_to_arrays(PER_LAYER, 4, 2, 1000, 6144)):
        np.testing.assert_array_equal(got, want)
    bad = (PER_LAYER[0], ("dense", "block_sparse", "dense", "dense"))
    for fn in (tmi.patterns_to_arrays, jmi.patterns_to_arrays):
        with pytest.raises(ValueError, match="block_sparse"):
            fn(bad, 4, 2, 1000, 6144)
    with pytest.raises(ValueError):
        tmi.patterns_to_arrays(PER_LAYER[:1], 4, 2, 1000, 6144)
    with pytest.raises(ValueError, match="kind"):
        tmi.resolve_patterns(["diagonal"] * 4, 4, 10, 10)


@pytest.mark.parametrize("b", [1, 2])
def test_flat_heads_rows_are_contiguous(b):
    """flat_heads gives the kernels' [B*N, S_pad, Dh] rows contiguous, also
    at B 1 (where the reshape alone returns a strided view), zero past S."""
    q = _t(_qkv(0, b, 40, 4, 2, dh=24)[0])
    rows = tmi.flat_heads(q, 64)
    assert rows.shape == (b * 4, 64, 24) and rows.is_contiguous()
    np.testing.assert_array_equal(
        rows.reshape(b, 4, 64, 24)[:, :, :40].numpy(),
        q.transpose(1, 2).numpy())
    assert not rows.reshape(b, 4, 64, 24)[:, :, 40:].any()

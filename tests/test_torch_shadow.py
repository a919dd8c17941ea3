"""Shadow-cache building blocks of the PyTorch port against the JAX package
on the same numpy inputs: low-rank factors, landmarks and outliers,
selection, slot-stable reuse, miss compaction, int8 stores, the cache
geometry, and one decode layer through the XLA-gather branch (tensor
gather and ring gather, with and without the forced ``debug_hit_rate``
selection). float32 module math at atol = rtol = 1e-5 unless stated; int8
values, bf16 scales and integer ids exactly equal."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.cache.shadow import ShadowLayout as JLayout
from shadowkv_tpu.cache.shadow import ShadowMut, ShadowStatic
from shadowkv_tpu.cache.shadow import shadow_decode_layer as j_decode_layer
from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.core import lowrank as jlr
from shadowkv_tpu.core import quant as jq
from shadowkv_tpu.core import selection as jsel
from shadowkv_tpu.core import rope as jrope
from shadowkv_tpu.kernels.reconstruct import compact_misses as j_compact
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.cache.shadow import ShadowCache as TShadowCache
from shadowkv_tpu_torch.cache.shadow import ShadowLayout as TLayout
from shadowkv_tpu_torch.cache.shadow import shadow_decode_layer as t_decode_layer
from shadowkv_tpu_torch.config import CacheConfig as TCache
from shadowkv_tpu_torch.core import lowrank as tlr
from shadowkv_tpu_torch.core import quant as tq
from shadowkv_tpu_torch.core import rope as trope
from shadowkv_tpu_torch.core import selection as tsel
from shadowkv_tpu_torch.models.registry import toy_config as t_toy

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _factors_product(u, sv):
    return np.einsum("bsr,bkrd->bksd", np.asarray(u), np.asarray(sv))


@pytest.mark.parametrize("rank", [32, 64])
def test_lowrank_same_sketch(rank):
    """Same Gaussian sketch on both sides: U @ SV agrees to f32 precision
    (the factors themselves only up to per-direction sign)."""
    b, s, kh, dh = 2, 384, 2, 128
    d, p = kh * dh, rank + 32
    k = np.random.default_rng(rank).standard_normal((b, s, d)).astype(np.float32)
    omega = jax.random.normal(jax.random.PRNGKey(7), (d, p), jnp.float32)
    uj, svj = jlr.lowrank_kv_factors(jnp.asarray(k), rank, kh, dh,
                                     dtype=jnp.float32)
    ut, svt = tlr.lowrank_kv_factors(_t(k), rank, kh, dh, dtype=torch.float32,
                                     omega=_t(omega))
    pj, pt = _factors_product(uj, svj), _factors_product(ut, svt)
    # four f32 whitening eigh passes on each side: 1e-4 of the largest entry
    np.testing.assert_allclose(pt, pj, atol=1e-4 * np.abs(pj).max(), rtol=0)
    # the factors agree up to one sign per singular direction
    sign = np.sign(np.einsum("bsr,bsr->br", np.asarray(uj), ut.numpy()))
    np.testing.assert_allclose(ut.numpy() * sign[:, None], np.asarray(uj),
                               atol=1e-3)


def test_lowrank_full_sketch_is_sketch_independent():
    """rank + 32 >= K*Dh: each side draws its OWN sketch and U @ SV still
    agrees, since the sketch spans the whole feature space. The keys are
    low-rank plus noise (the ShadowKV premise): with a flat spectrum the f32
    whitening drops sketch-dependent tail directions instead (ROADMAP §3)."""
    b, s, kh, dh, rank = 1, 384, 2, 128, 224
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((b, s, 200)) @ rng.standard_normal((200, kh * dh))
         / 16 + 1e-4 * rng.standard_normal((b, s, kh * dh))).astype(np.float32)
    uj, svj = jlr.lowrank_kv_factors(jnp.asarray(k), rank, kh, dh,
                                     dtype=jnp.float32)
    ut, svt = tlr.lowrank_kv_factors(_t(k), rank, kh, dh, dtype=torch.float32)
    pj, pt = _factors_product(uj, svj), _factors_product(ut, svt)
    np.testing.assert_allclose(pt, pj, atol=1e-5 * np.abs(pj).max(), rtol=0)


def test_reconstruct_keys():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 64, 16)).astype(np.float32)
    sv = rng.standard_normal((2, 3, 16, 128)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 3, 10)).astype(np.int32)
    ref = jlr.reconstruct_keys(jnp.asarray(u), jnp.asarray(sv), jnp.asarray(pos))
    out = tlr.reconstruct_keys(_t(u), _t(sv), _t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_landmarks_and_outliers():
    k = np.random.default_rng(3).standard_normal((2, 2, 24, 16, 128)).astype(np.float32)
    j = jsel.compute_landmarks_outliers(jnp.asarray(k), 4)
    t = tsel.compute_landmarks_outliers(_t(k), 4)
    np.testing.assert_allclose(t.landmarks.numpy(), np.asarray(j.landmarks), **TOL)
    np.testing.assert_array_equal(t.landmark_mask.numpy(), np.asarray(j.landmark_mask))
    np.testing.assert_array_equal(
        np.sort(t.outlier_idx.numpy(), -1), np.sort(np.asarray(j.outlier_idx), -1)
    )


@pytest.mark.parametrize("int8, hysteresis", [(False, 0.0), (True, 0.0), (True, 0.3)])
def test_score_and_select(int8, hysteresis):
    rng = np.random.default_rng(4)
    b, kh, g, q, c, dh, s = 2, 2, 3, 2, 40, 128, 8
    query = rng.standard_normal((b, kh, g, q, dh)).astype(np.float32)
    lms = rng.standard_normal((b, kh, c, dh)).astype(np.float32)
    mask = rng.random((b, kh, c)) > 0.15
    resident = np.stack([rng.permutation(c)[:s] for _ in range(b * kh)])
    resident = resident.reshape(b, kh, s).astype(np.int32)
    lm_scale = None
    if int8:
        lq, sc = tq.quantize_rows(_t(lms))
        lms, lm_scale = lq.numpy(), sc.numpy()
    kw_j = dict(landmark_scale=None if lm_scale is None else jnp.asarray(lm_scale),
                resident_ids=jnp.asarray(resident), hysteresis=hysteresis)
    kw_t = dict(landmark_scale=None if lm_scale is None else _t(lm_scale),
                resident_ids=_t(resident), hysteresis=hysteresis)
    ref = jsel.score_and_select(jnp.asarray(query), jnp.asarray(lms),
                                jnp.asarray(mask), s, **kw_j)
    out = tsel.score_and_select(_t(query), _t(lms), _t(mask), s, **kw_t)
    # only membership matters downstream (assign_slots_stable sorts)
    np.testing.assert_array_equal(np.sort(out.numpy(), -1),
                                  np.sort(np.asarray(ref), -1))


def _distinct_ids(rng, b, kh, s, c):
    return np.stack([rng.permutation(c)[:s] for _ in range(b * kh)]).reshape(
        b, kh, s).astype(np.int32)


def test_assign_slots_stable_and_compact_misses():
    rng = np.random.default_rng(5)
    b, kh, s, c = 3, 2, 16, 40
    prev = _distinct_ids(rng, b, kh, s, c)
    new = prev.copy()
    for i in range(b):
        for j in range(kh):
            n_new = rng.integers(0, s + 1)
            fresh = np.setdiff1d(rng.permutation(c), prev[i, j])[:n_new]
            new[i, j, rng.permutation(s)[:n_new]] = fresh
            new[i, j] = rng.permutation(new[i, j])
    ja = jsel.assign_slots_stable(jnp.asarray(prev), jnp.asarray(new))
    ta = tsel.assign_slots_stable(_t(prev), _t(new))
    np.testing.assert_array_equal(ta.slot_ids.numpy(), np.asarray(ja.slot_ids))
    np.testing.assert_array_equal(ta.stay_mask.numpy(), np.asarray(ja.stay_mask))
    np.testing.assert_array_equal(ta.stay_count.numpy(), np.asarray(ja.stay_count))
    jc = j_compact(ja.slot_ids, ja.stay_mask)
    tc = tsel.compact_misses(ta.slot_ids, ta.stay_mask)
    for a, b_ in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    # the refresh invariant: each miss list ascends without duplicates
    mc, cnt = tc[0].numpy(), tc[2].numpy()
    for i in range(b):
        for j in range(kh):
            assert np.all(np.diff(mc[i, j, : cnt[i, j]]) > 0)


def test_chunk_ids_to_positions_and_take_small_int():
    ids = np.random.default_rng(6).integers(0, 50, (2, 3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tsel.chunk_ids_to_positions(_t(ids), 16).numpy(),
        np.asarray(jsel.chunk_ids_to_positions(jnp.asarray(ids), 16)),
    )
    idx = np.random.default_rng(7).integers(0, 5, (2, 3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tsel.take_small_int(_t(ids), _t(idx)).numpy(),
        np.asarray(jsel.take_small_int(jnp.asarray(ids), jnp.asarray(idx))),
    )


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_rows(dtype):
    x = (np.random.default_rng(8).standard_normal((3, 7, 64)) * 3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = _t(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    qj, sj = jq.quantize_rows(xj)
    qt, st = tq.quantize_rows(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(
        tq.dequantize(qt, st, torch.float32).numpy(),
        np.asarray(jq.dequantize(qj, sj, jnp.float32)), **TOL)


def test_int8_stores_match_packed_jax_stores():
    """The port's plain int8 stores (values + bf16 scales in their own
    tensors) dequantize to exactly the values of the JAX package's tiled
    pack_shadow_int8 stores."""
    rng = np.random.default_rng(9)
    c, cs, rank, kh, dh, rp = 8, 16, 64, 2, 128, 128
    u = np.zeros((c, cs, rp), np.float32)
    u[..., :rank] = rng.standard_normal((c, cs, rank))
    v = rng.standard_normal((kh, c, cs, dh)).astype(np.float32)
    u8, v8 = jq.pack_shadow_int8(jnp.asarray(u), jnp.asarray(v), rank=rank)
    u_ref = np.asarray(jq.unpack_u_int8(u8, cs, rp, jnp.float32))[..., :rank]
    v_ref = np.asarray(jq.unpack_v_int8(v8, u8, cs, rp, dh, jnp.float32))
    uq, us = tq.quantize_store(_t(u[..., :rank].reshape(c * cs, rank)))
    vq, vs = tq.quantize_store(_t(v.reshape(kh, c * cs, dh)))
    assert us.dtype == torch.bfloat16 and vs.dtype == torch.bfloat16
    u_port = (uq.float() * us.float()[..., None]).numpy().reshape(c, cs, rank)
    v_port = (vq.float() * vs.float()[..., None]).numpy().reshape(kh, c, cs, dh)
    np.testing.assert_array_equal(u_port, u_ref)
    np.testing.assert_array_equal(v_port, v_ref)


@pytest.mark.parametrize("prefill_len", [1024, 1032, 4096, 32768, 122880])
@pytest.mark.parametrize("budget, cs", [(128, 16), (2048, 16), (2048, 8)])
def test_layout_geometry(prefill_len, budget, cs):
    kw = dict(sparse_budget=budget, chunk_size=cs, rank=160, kv_quant="int8",
              gen_capacity=256, max_length=prefill_len)
    try:
        j = JLayout.build(JCache(**kw), prefill_len, num_kv_heads=8)
    except AssertionError:
        with pytest.raises(ValueError):
            TLayout.build(TCache(**kw), prefill_len)
        return
    t = TLayout.build(TCache(**kw), prefill_len)
    for f in ("prefill_len", "chunk_size", "chunks", "prefill_local",
              "outlier_chunks", "num_landmarks", "select_sets",
              "sparse_start", "sparse_end", "gen_capacity", "buffer_cap",
              "rank", "quant"):
        assert getattr(t, f) == getattr(j, f), f


def test_layout_rejects_unaligned_prefill():
    with pytest.raises(ValueError):
        TLayout.build(TCache(sparse_budget=128, chunk_size=16), 1028)


# --------------------------------------------------------------------------
# One decode layer, XLA-gather branch
# --------------------------------------------------------------------------

DEC = dict(head_dim=128, num_heads=4, num_kv_heads=2)
DEC_PROMPT, DEC_RANK, DEC_GEN = 512, 40, 3


def _decode_inputs(seed, quant, ring):
    """Both packages' caches packed from the same float values, plus the
    step's queries and new K/V rows."""
    jcfg, tcfg = j_toy(dtype=jnp.float32, **DEC), t_toy(dtype=torch.float32, **DEC)
    kw = dict(mode="shadow", max_length=DEC_PROMPT + 32, sparse_budget=128,
              rank=DEC_RANK, chunk_size=16, outlier_chunks=4, gen_capacity=16,
              kv_quant=quant)
    jl = JLayout.build(JCache(**kw), DEC_PROMPT, kernel_store=ring,
                       num_kv_heads=jcfg.num_kv_heads)
    tl = TLayout.build(TCache(**kw), DEC_PROMPT)
    rng = np.random.default_rng(seed)
    l, b, kh, h, dh = jcfg.num_layers, 2, jcfg.num_kv_heads, jcfg.num_heads, 128
    c, cs, s, cap, rp = tl.chunks, tl.chunk_size, tl.select_sets, tl.buffer_cap, jl.rank_pad

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    u, sv, v = f(l, b, c, cs, DEC_RANK), f(l, b, kh, DEC_RANK, dh, scale=0.1), f(l, b, kh, c, cs, dh)
    lms, k_buf, v_buf = f(l, b, kh, c, dh), f(l, b, kh, cap, dh), f(l, b, kh, cap, dh)
    mask = rng.random((l, b, kh, c)) > 0.15
    ids = np.stack([rng.permutation(c)[:s] for _ in range(l * b * kh)])
    ids = ids.reshape(l, b, kh, s).astype(np.int32)
    step = dict(q=f(b, 1, h, dh), k_new=f(b, 1, kh, dh), v_new=f(b, 1, kh, dh))

    u_pad = np.zeros((l, b, c, cs, rp), np.float32)
    u_pad[..., :DEC_RANK] = u
    sv_pad = np.zeros((l, b, kh, rp, dh), np.float32)
    sv_pad[..., :DEC_RANK, :] = sv
    u_t = _t(u.reshape(l, b, c * cs, DEC_RANK))
    v_t = _t(v.reshape(l, b, kh, c * cs, dh))
    lm_sc = u_sc = v_sc = None
    if quant == "int8":
        j_u, j_v = jq.pack_shadow_int8(jnp.asarray(u_pad), jnp.asarray(v),
                                       rank=DEC_RANK, tiled=ring)
        lq, lm_sc = tq.quantize_rows(_t(lms))
        lms = lq.numpy()
        u_t, u_sc = tq.quantize_store(u_t)
        v_t, v_sc = tq.quantize_store(v_t)
    else:
        j_u, j_v = jnp.asarray(u_pad), jnp.asarray(v)
    jstate = (
        ShadowStatic(u=j_u, sv=jnp.asarray(sv_pad), landmarks=jnp.asarray(lms),
                     landmark_mask=jnp.asarray(mask), v_full=j_v,
                     lm_scale=None if lm_sc is None else jnp.asarray(lm_sc.numpy())),
        ShadowMut(k_buf=jnp.asarray(k_buf), v_buf=jnp.asarray(v_buf),
                  cached_ids=jnp.asarray(ids)),
    )
    tcache = TShadowCache(
        u=u_t, sv=_t(sv), landmarks=_t(lms), landmark_mask=_t(mask),
        k_buf=_t(k_buf), v_buf=_t(v_buf), v_full=v_t, cached_ids=_t(ids),
        layout=tl, gen_len=DEC_GEN, lm_scale=lm_sc, u_scale=u_sc, v_scale=v_sc,
    )
    return jcfg, jl, jstate, tcfg, tcache, step


def _decode_both(quant, ring, layer=1, seed=11, **force):
    jcfg, jl, (static, mut), tcfg, cache, step = _decode_inputs(seed, quant, ring)
    n = DEC_PROMPT + 32 + 16
    jcos, jsin = jrope.compute_cos_sin(jcfg, n, jnp.float32)
    tcos, tsin = trope.compute_cos_sin(tcfg, n, torch.float32)
    _, _, jvalid, mut = j_decode_layer(
        jcfg, jl, static, mut, jnp.int32(DEC_GEN), jnp.int32(layer),
        *(jnp.asarray(step[k]) for k in ("q", "k_new", "v_new")), jcos, jsin,
        ring_gather=ring, **force)
    _, _, tvalid = t_decode_layer(
        tcfg, cache, layer, *(_t(step[k]) for k in ("q", "k_new", "v_new")),
        trope.inv_freq_full_neox(tcfg), use_kernel=False, ring=ring,
        cos_table=tcos, sin_table=tsin, **force)
    assert tvalid == int(jvalid)
    np.testing.assert_array_equal(cache.cached_ids.numpy(), np.asarray(mut.cached_ids))
    np.testing.assert_allclose(cache.k_buf.numpy(), np.asarray(mut.k_buf), **TOL)
    if quant == "int8":  # exact int8 x bf16 products, one rounding each side
        np.testing.assert_array_equal(cache.v_buf.numpy(), np.asarray(mut.v_buf))
    else:
        np.testing.assert_allclose(cache.v_buf.numpy(), np.asarray(mut.v_buf), **TOL)
    return cache


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("quant", ["int8", "none"])
def test_xla_gather_decode_layer_matches_jax(quant, ring):
    _decode_both(quant, ring)


@pytest.mark.parametrize("layout", ["scatter", "contig"])
def test_debug_hit_rate_forced_ids_match_jax(layout):
    """The forced window (benchmark-only) selects the same ids as JAX's,
    including the scatter bijection's multiplier."""
    cache = _decode_both("int8", False, debug_hit_rate=0.5,
                         debug_hit_layout=layout)
    lo = cache.layout
    m = lo.select_sets // 2  # the window slides by S * (1 - 0.5)
    window = (DEC_GEN * m + np.arange(lo.select_sets)) % lo.chunks
    if layout == "scatter":
        window = window * 4097 % lo.chunks  # gcd(4097, 24) = 1
    for ids in cache.cached_ids[1].reshape(-1, lo.select_sets).tolist():
        assert set(ids) == set(window.tolist())

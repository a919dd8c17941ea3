"""The port's sparse refresh (kernel A; its plain version runs for CPU
tensors) against the JAX package's Pallas ``sparse_refresh`` in interpret
mode, on the cases the JAX kernel tests use: unquantized and int8 stores,
neox and glm partial RoPE, all-hits no-op, contiguous miss runs; head_dim
128. Both sides get the same numpy stores (int8 ones quantized by the JAX
packer and, identically, by the port); buffers compare at atol = rtol =
1e-5 (f32 sums in another order), V rows of int8 stores exactly."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.core.quant import pack_shadow_int8, scale_lanes_for
from shadowkv_tpu.kernels.reconstruct import compact_misses as j_compact
from shadowkv_tpu.kernels.reconstruct import sparse_refresh as j_refresh
from shadowkv_tpu_torch.core.quant import quantize_store
from shadowkv_tpu_torch.core.selection import compact_misses
from shadowkv_tpu_torch.kernels.reconstruct import (
    sparse_refresh,
    sparse_refresh_plain,
)

L, B, K, DH = 2, 2, 2, 128
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Run this file's torch work on the calling thread. In a fresh pytest
    worker a new intra-op thread has, at times, computed its share of the
    plain refresh's f32 product ~1.2e-4 relative off (one thread's 1/8 of
    the rows, with the BLAS product and an elementwise one alike; ROADMAP
    §3). The arithmetic and the tolerance are unchanged."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inv_freq_full(rope_dim, style, theta=10000.0):
    invf = 1.0 / theta ** (np.arange(0, rope_dim, 2, dtype=np.float64) / rope_dim)
    if style == "neox":
        return np.concatenate([invf, invf]).astype(np.float32)
    full = np.zeros(DH)
    full[:rope_dim] = np.repeat(invf, 2)
    return full.astype(np.float32)


def _case(seed, c, cs, s_sets, rank, quant, slot_ids=None, stay=None):
    rng = np.random.default_rng(seed)
    sparse_start = 16
    cap = sparse_start + s_sets * cs + 16
    u = rng.standard_normal((L, B, c, cs, rank)).astype(np.float32)
    sv = rng.standard_normal((L, B, K, rank, DH)).astype(np.float32) * 0.1
    v = rng.standard_normal((L, B, K, c, cs, DH)).astype(np.float32)
    k_buf = rng.standard_normal((L, B, K, cap, DH)).astype(np.float32)
    v_buf = rng.standard_normal((L, B, K, cap, DH)).astype(np.float32)
    if slot_ids is None:
        slot_ids = np.stack([rng.permutation(c)[:s_sets]
                             for _ in range(B * K)]).reshape(B, K, s_sets)
        slot_ids = np.sort(slot_ids, -1)  # as assign_slots_stable places misses
    if stay is None:
        stay = rng.random((B, K, s_sets)) < 0.5
    return dict(u=u, sv=sv, v=v, k_buf=k_buf, v_buf=v_buf, cs=cs, rank=rank,
                slot_ids=slot_ids.astype(np.int32), stay=stay, quant=quant,
                sparse_start=sparse_start)


def _run_jax(cs_, layer, rope_dim, style):
    u, sv, v = cs_["u"], cs_["sv"], cs_["v"]
    rank, cs = cs_["rank"], cs_["cs"]
    if cs_["quant"]:
        rp = ((rank + scale_lanes_for(K) + 127) // 128) * 128
        u_pad = np.zeros(u.shape[:-1] + (rp,), np.float32)
        u_pad[..., :rank] = u
        sv_pad = np.zeros(sv.shape[:-2] + (rp, DH), np.float32)
        sv_pad[..., :rank, :] = sv
        u_in, v_in = pack_shadow_int8(jnp.asarray(u_pad), jnp.asarray(v), rank=rank)
        sv_in = jnp.asarray(sv_pad)
    else:
        u_in, v_in, sv_in = jnp.asarray(u), jnp.asarray(v), jnp.asarray(sv)
    mc, ms, cnt = j_compact(jnp.asarray(cs_["slot_ids"]), jnp.asarray(cs_["stay"]))
    k_out, v_out = j_refresh(
        jnp.asarray(layer, jnp.int32), mc, ms, cnt, u_in, sv_in, v_in,
        jnp.asarray(_inv_freq_full(rope_dim, style))[None],
        jnp.asarray(cs_["k_buf"]), jnp.asarray(cs_["v_buf"]),
        chunk_size=cs, sparse_start=cs_["sparse_start"], rope_dim=rope_dim,
        rope_style=style, interpret=True,
    )
    return np.asarray(k_out), np.asarray(v_out)


def _run_port(cs_, layer, rope_dim, style, fn=sparse_refresh):
    rank, cs = cs_["rank"], cs_["cs"]
    c = cs_["u"].shape[2]
    u = torch.from_numpy(cs_["u"].reshape(L, B, c * cs, rank))
    v = torch.from_numpy(cs_["v"].reshape(L, B, K, c * cs, DH))
    u_sc = v_sc = None
    if cs_["quant"]:
        u, u_sc = quantize_store(u)
        v, v_sc = quantize_store(v)
    k_buf = torch.from_numpy(cs_["k_buf"].copy())
    v_buf = torch.from_numpy(cs_["v_buf"].copy())
    mc, ms, cnt = compact_misses(torch.from_numpy(cs_["slot_ids"]),
                                 torch.from_numpy(cs_["stay"]))
    k_out, v_out = fn(
        layer, mc, ms, cnt, u, torch.from_numpy(cs_["sv"]), v,
        torch.from_numpy(_inv_freq_full(rope_dim, style)), k_buf, v_buf,
        chunk_size=cs, sparse_start=cs_["sparse_start"], rope_dim=rope_dim,
        rope_style=style, u_scale=u_sc, v_scale=v_sc,
    )
    assert k_out is k_buf and v_out is v_buf  # updated in place
    return k_out.numpy(), v_out.numpy()


def _compare(case, layer=1, rope_dim=DH, style="neox"):
    kj, vj = _run_jax(case, layer, rope_dim, style)
    kt, vt = _run_port(case, layer, rope_dim, style)
    np.testing.assert_allclose(kt, kj, **TOL)
    if case["quant"]:
        np.testing.assert_array_equal(vt, vj)
    else:
        np.testing.assert_allclose(vt, vj, **TOL)
    return kt, vt


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_refresh_matches_jax(quant, layer):
    _compare(_case(10 + layer, c=24, cs=16, s_sets=8, rank=32, quant=quant),
             layer=layer)


@pytest.mark.parametrize("quant", [False, True])
def test_refresh_glm_partial_rope(quant):
    _compare(_case(20, c=24, cs=16, s_sets=8, rank=32, quant=quant),
             rope_dim=64, style="glm")


def test_refresh_chunk8():
    _compare(_case(30, c=32, cs=8, s_sets=12, rank=32, quant=True))


def test_refresh_all_hits_is_a_noop():
    case = _case(40, c=24, cs=16, s_sets=8, rank=32, quant=True,
                 stay=np.ones((B, K, 8), bool))
    kt, vt = _compare(case)
    np.testing.assert_array_equal(kt, case["k_buf"])
    np.testing.assert_array_equal(vt, case["v_buf"])


@pytest.mark.parametrize("quant", [False, True])
def test_refresh_contiguous_runs(quant):
    """All-miss contiguous chunk runs (the TPU kernel's batched-fetch path:
    groups of 16 consecutive chunks) plus a head whose run starts off a
    tile boundary and a head with one hit breaking a group."""
    s_sets, c = 40, 80
    slot_ids = np.stack([np.arange(0, s_sets), np.arange(13, 13 + s_sets)])
    slot_ids = np.broadcast_to(slot_ids, (B, K, s_sets)).copy()
    stay = np.zeros((B, K, s_sets), bool)
    stay[1, 1, 20] = True
    _compare(_case(50, c=c, cs=8, s_sets=s_sets, rank=32, quant=quant,
                   slot_ids=slot_ids, stay=stay))


def test_wrapper_takes_plain_version_on_cpu():
    case = _case(60, c=24, cs=16, s_sets=8, rank=32, quant=True)
    a = _run_port(case, 1, DH, "neox", fn=sparse_refresh)
    b = _run_port(case, 1, DH, "neox", fn=sparse_refresh_plain)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert sparse_refresh.launches == 0  # launches count CUDA kernels only

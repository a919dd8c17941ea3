"""The port's CUDA kernels against their plain versions on the card, at
small shapes. These need an NVIDIA GPU and skip without one; on the GPU
machine run ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: K rows within 2 bf16 ulps of the largest value (f32 sums in
another order, one bf16 rounding); int8 V rows exact; gathered chunks
bit-equal (the gather moves bytes only); attention outputs within 2^-6 of
each row's largest value, per (b, s, h) row, since the output's scale falls
with the row index (bf16 probabilities and one bf16 rounding give a few
2^-9); the sparse prefill kernels (C, F, G) are held to the same per-row
bound on the rows below ``seq_len``. The attention kernels (B, C, F, G)
give one batch row alone the same bits as that row inside a batch. The
refresh and the gather run with the V store on the card and pinned in host
memory."""

from __future__ import annotations

import pytest
import torch

from shadowkv_tpu_torch.core.attention import (
    causal_prefill_attention,
    sparse_prefill_attention,
)
from shadowkv_tpu_torch.core.minference import (
    meta_from_flags,
    vs_attention_reference,
)
from shadowkv_tpu_torch.core.quant import quantize_store
from shadowkv_tpu_torch.core.selection import assign_slots_stable, compact_misses
from shadowkv_tpu_torch.kernels.gather import gather_chunks, gather_chunks_plain
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_splash,
    sparse_prefill_splash,
)
from shadowkv_tpu_torch.kernels.reconstruct import (
    sparse_refresh,
    sparse_refresh_plain,
)
from shadowkv_tpu_torch.kernels.vs_sparse import vs_sparse_attention
from shadowkv_tpu_torch.kernels.vs_tile import (
    vs_tile_attention,
    vs_tok_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16_tol(ref):
    return 2.0**-7 * float(ref.float().abs().max())


def _row_rel_err(out, ref):
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    return float((err / ref.float().abs().amax(dim=-1).clamp_min(1e-6)).max())


@pytest.mark.parametrize("quant, style, cs, host_v", [
    (True, "neox", 16, False), (False, "neox", 16, False),
    (True, "glm", 16, False), (True, "neox", 8, False),
    (True, "neox", 16, True), (False, "neox", 16, True),
])
def test_refresh_kernel_matches_plain(gen, quant, style, cs, host_v):
    l, b, kh, c, rank, dh, s = 2, 2, 4, 64, 96, 128, 16
    dev = "cuda"
    u = torch.randn(l, b, c * cs, rank, device=dev, generator=gen).bfloat16()
    v = torch.randn(l, b, kh, c * cs, dh, device=dev, generator=gen).bfloat16()
    sv = (0.05 * torch.randn(l, b, kh, rank, dh, device=dev, generator=gen)).bfloat16()
    u_sc = v_sc = None
    if quant:
        u, u_sc = quantize_store(u)
        v, v_sc = quantize_store(v)
    cap = 32 + s * cs + 16
    k_buf = torch.randn(l, b, kh, cap, dh, device=dev, generator=gen).bfloat16()
    v_buf = torch.randn(l, b, kh, cap, dh, device=dev, generator=gen).bfloat16()
    prev = torch.stack([torch.randperm(c, device=dev, generator=gen)[:s]
                        for _ in range(b * kh)]).reshape(b, kh, s).int()
    new = torch.stack([torch.randperm(c, device=dev, generator=gen)[:s]
                       for _ in range(b * kh)]).reshape(b, kh, s).int()
    new[0, 0] = prev[0, 0]  # one all-hit head
    asg = assign_slots_stable(prev, new)
    mc, ms, cnt = compact_misses(asg.slot_ids, asg.stay_mask)
    rope_dim = 64 if style == "glm" else dh
    inv = torch.zeros(dh, device=dev)
    invf = 1.0 / 10000.0 ** (torch.arange(0, rope_dim, 2, device=dev) / rope_dim)
    if style == "glm":
        inv[:rope_dim] = torch.repeat_interleave(invf, 2)
    else:
        inv = torch.cat([invf, invf])
    kw = dict(chunk_size=cs, sparse_start=32, rope_dim=rope_dim,
              rope_style=style, u_scale=u_sc, v_scale=v_sc)
    k_ref, v_ref = k_buf.clone(), v_buf.clone()
    sparse_refresh_plain(1, mc, ms, cnt, u, sv, v, inv, k_ref, v_ref, **kw)
    v_in = v.cpu().pin_memory() if host_v else v
    before = (sparse_refresh.launches, sparse_refresh.host_launches)
    sparse_refresh(1, mc, ms, cnt, u, sv, v_in, inv, k_buf, v_buf, **kw)
    torch.cuda.synchronize()
    assert (sparse_refresh.launches, sparse_refresh.host_launches) == (
        before[0] + 1, before[1] + int(host_v))
    assert float((k_buf.float() - k_ref.float()).abs().max()) <= _bf16_tol(k_ref)
    assert torch.equal(v_buf, v_ref)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("s", [72, 129, 200, 256, 1000])
def test_prefill_attention_kernel_matches_plain(gen, s, g):
    kh, dh = 2, 128
    q = torch.randn(2, s, kh * g, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    ref = causal_prefill_attention(q, k, v)
    before = causal_prefill_splash.launches
    out = causal_prefill_splash(q, k, v)
    torch.cuda.synchronize()
    assert causal_prefill_splash.launches == before + 1
    assert _row_rel_err(out, ref) <= 2.0**-6


@pytest.mark.parametrize("s, g, window, sink", [
    (200, 4, 64, 16), (256, 2, 100, 0), (130, 8, 1, 70), (300, 4, 0, 64),
    (72, 2, 1000, 1000), (1000, 1, 300, 129), (1000, 8, 256, 128),
    (129, 2, 128, 1), (1000, 4, 129, 0), (256, 1, 130, 200),
])
def test_sparse_prefill_kernel_matches_plain(gen, s, g, window, sink):
    kh, dh = 2, 128
    q = torch.randn(2, s, kh * g, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    ref = sparse_prefill_attention(q, k, v, window, sink)
    before = (sparse_prefill_splash.launches, causal_prefill_splash.launches)
    out = sparse_prefill_splash(q, k, v, window, sink)
    torch.cuda.synchronize()
    assert (sparse_prefill_splash.launches, causal_prefill_splash.launches) \
        == (before[0] + 1, before[1])
    assert _row_rel_err(out, ref) <= 2.0**-6


@pytest.mark.parametrize("window, sink", [(None, None), (300, 129)])
def test_prefill_attention_batch_rows_are_independent(gen, window, sink):
    """B 2 at a ragged S with different data per batch row (row 1's V 10^4
    times larger): each row's output is bit-equal to the kernel's output
    for that row alone, so no tile reads the other row (the 4-D TMA maps
    zero-fill past S instead)."""
    s, kh, g, dh = 200, 2, 4, 128
    q = torch.randn(2, s, kh * g, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v[1] *= 1e4

    def run(*t):
        if window is None:
            return causal_prefill_splash(*t)
        return sparse_prefill_splash(*t, window, sink)

    out = run(q, k, v)
    for b in range(2):
        alone = run(q[b:b + 1].clone(), k[b:b + 1].clone(), v[b:b + 1].clone())
        torch.cuda.synchronize()
        assert torch.equal(out[b:b + 1], alone)
    ref = (causal_prefill_attention(q, k, v) if window is None
           else sparse_prefill_attention(q, k, v, window, sink))
    assert _row_rel_err(out, ref) <= 2.0**-6


def _vs_inputs(gen, b=2, h=4, kh=2, s_pad=512):
    q = torch.randn(b * h, s_pad, 128, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b * kh, s_pad, 128, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b * kh, s_pad, 128, device="cuda", generator=gen).bfloat16()
    kv_map = ((torch.arange(b)[:, None] * kh
               + torch.arange(h)[None, :] // (h // kh)).reshape(-1)
              .int().cuda())
    return q, k, v, kv_map


# (block, S_pad, seq_len): blocks {64, 128, 256} x ragged seq_len at S_pad
# 512, S_pad a multiple of 64 but not of 128, and a block that is a
# multiple of 64 but not a power of two.
VS_CASES = [(block, 512, seq_len) for block in (64, 128, 256)
            for seq_len in (512, 459, 333)] + [(64, 448, 391), (192, 576, 500)]


def _vs_tile_args(gen, block, s_pad, seq_len, b=2):
    q, k, v, kv_map = _vs_inputs(gen, b=b, s_pad=s_pad)
    bh = q.shape[0]
    dflag = (torch.rand(bh, -(-s_pad // block), device="cuda",
                        generator=gen) < 0.3).int()
    dflag[:, 0] = 1
    # verticals with duplicates, entries past seq_len and pads
    v_idx = torch.randint(0, s_pad, (bh, 300), device="cuda", generator=gen,
                          dtype=torch.int32)
    v_idx[:, 10:20] = v_idx[:, :10]
    v_idx[:, -8:] = 2 * s_pad
    return q, k, v, v_idx, dflag, kv_map


def _vs_sparse_args(gen, block, s_pad, seq_len, b=2):
    q, k, v, kv_map = _vs_inputs(gen, b=b, s_pad=s_pad)
    bh = q.shape[0]
    nk = s_pad // block
    col = (torch.rand(bh, nk, device="cuda", generator=gen) < 0.3).int()
    diag = (torch.rand(bh, nk, device="cuda", generator=gen) < 0.3).int()
    diag[:, 0] = 1
    meta = meta_from_flags(col, diag)
    return (q, k, v, meta.col_ids, meta.col_cnt, meta.col_flag,
            meta.diag_ids, meta.diag_cnt, kv_map), meta


@pytest.mark.parametrize("block, s_pad, seq_len", VS_CASES)
def test_vs_tile_kernel_matches_plain(gen, block, s_pad, seq_len):
    q, k, v, v_idx, dflag, kv_map = _vs_tile_args(gen, block, s_pad, seq_len)
    kw = dict(block=block, scale=128**-0.5, seq_len=seq_len)
    ref = vs_tok_attention_reference(q, k, v, v_idx, dflag, kv_map, **kw)
    before = vs_tile_attention.launches
    out = vs_tile_attention(q, k, v, v_idx, dflag, kv_map, **kw)
    torch.cuda.synchronize()
    assert vs_tile_attention.launches == before + 1
    assert _row_rel_err(out[:, :seq_len], ref[:, :seq_len]) <= 2.0**-6


@pytest.mark.parametrize("block, s_pad, seq_len", VS_CASES)
def test_vs_sparse_kernel_matches_plain(gen, block, s_pad, seq_len):
    args, meta = _vs_sparse_args(gen, block, s_pad, seq_len)
    q, k, v, kv_map = args[0], args[1], args[2], args[-1]
    kw = dict(block=block, scale=128**-0.5, seq_len=seq_len)
    ref = vs_attention_reference(q, k, v, meta, kv_map, **kw)
    before = vs_sparse_attention.launches
    out = vs_sparse_attention(*args, **kw)
    torch.cuda.synchronize()
    assert vs_sparse_attention.launches == before + 1
    assert _row_rel_err(out[:, :seq_len], ref[:, :seq_len]) <= 2.0**-6


@pytest.mark.parametrize("kernel", ["F", "G"])
def test_vs_kernel_batch_rows_are_independent(gen, kernel):
    """F and G at a ragged S with different data per row (the second K/V
    row's V 10^4 times larger): each row of [B*H] gives the same bits
    alone (with its own K/V row) as inside the batch, so no tile reads
    another row (the maps zero-fill past S_pad instead)."""
    block, s_pad, seq_len = 64, 448, 391
    if kernel == "F":
        q, k, v, v_idx, dflag, kv_map = _vs_tile_args(gen, block, s_pad,
                                                      seq_len)
        run = lambda q, k, v, r: vs_tile_attention(  # noqa: E731
            q, k, v, v_idx[r], dflag[r], kv_map[r] - kv_map[r][0],
            block=block, scale=128**-0.5, seq_len=seq_len)
    else:
        args, _ = _vs_sparse_args(gen, block, s_pad, seq_len)
        q, k, v, kv_map = args[0], args[1], args[2], args[-1]
        run = lambda q, k, v, r: vs_sparse_attention(  # noqa: E731
            q, k, v, *(t[r].contiguous() for t in args[3:8]),
            (kv_map[r] - kv_map[r][0]).contiguous(), block=block,
            scale=128**-0.5, seq_len=seq_len)
    v[1] *= 1e4
    every = slice(None)
    out = run(q, k, v, every)
    for r in range(q.shape[0]):
        kv = int(kv_map[r])
        alone = run(q[r:r + 1].clone(), k[kv:kv + 1].clone(),
                    v[kv:kv + 1].clone(), slice(r, r + 1))
        torch.cuda.synchronize()
        assert torch.equal(out[r:r + 1], alone), r


def _gather_inputs(gen, quant, l=2, b=2, kh=4, c=64, cs=16, rank=96, s=24):
    u = torch.randn(l, b, c * cs, rank, device="cuda", generator=gen).bfloat16()
    v = torch.randn(l, b, kh, c * cs, 128, device="cuda", generator=gen).bfloat16()
    u_sc = v_sc = None
    if quant:
        u, u_sc = quantize_store(u)
        v, v_sc = quantize_store(v)
    ids = torch.randint(0, c, (b, kh, s), device="cuda", generator=gen,
                        dtype=torch.int32)
    return ids, u, v, u_sc, v_sc


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("host_v", [False, True])
def test_gather_kernel_matches_plain(gen, quant, host_v):
    ids, u, v, u_sc, v_sc = _gather_inputs(gen, quant)
    ref = gather_chunks_plain(1, ids, u, v, u_sc, v_sc, chunk_size=16)
    v_in = v.cpu().pin_memory() if host_v else v
    before = (gather_chunks.launches, gather_chunks.host_launches)
    out = gather_chunks(1, ids, u, v_in, u_sc, v_sc, chunk_size=16)
    torch.cuda.synchronize()
    assert (gather_chunks.launches, gather_chunks.host_launches) == (
        before[0] + 1, before[1] + int(host_v))
    for got, want in zip(out, ref):
        if want is None:
            assert got is None
        else:
            assert got.is_cuda and torch.equal(got, want)


def test_host_store_must_be_pinned_and_the_rest_on_the_card(gen):
    ids, u, v, u_sc, v_sc = _gather_inputs(gen, True)
    with pytest.raises(ValueError, match="pinned"):
        gather_chunks(0, ids, u, v.cpu(), u_sc, v_sc, chunk_size=16)
    with pytest.raises(ValueError):
        gather_chunks(0, ids, u.cpu(), v, u_sc, v_sc, chunk_size=16)
    b, kh, s = ids.shape
    mc, ms, cnt = ids, ids, torch.full((b, kh), s, device="cuda",
                                        dtype=torch.int32)
    sv = torch.zeros(2, b, kh, u.shape[-1], 128, device="cuda").bfloat16()
    buf = torch.zeros(2, b, kh, 16 + s * 16, 128, device="cuda").bfloat16()
    inv = torch.ones(128, device="cuda")
    kw = dict(chunk_size=16, sparse_start=16, rope_dim=128, u_scale=u_sc,
              v_scale=v_sc)
    with pytest.raises(ValueError, match="pinned"):
        sparse_refresh(0, mc, ms, cnt, u, sv, v.cpu(), inv, buf, buf.clone(), **kw)
    with pytest.raises(ValueError):
        sparse_refresh(0, mc, ms, cnt, u.cpu(), sv, v, inv, buf, buf.clone(), **kw)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 64, 4, 128, device="cuda", generator=gen)  # f32
    with pytest.raises(ValueError):
        causal_prefill_splash(q, q[:, :, :2], q[:, :, :2])
    qb = q.bfloat16()
    with pytest.raises(ValueError):  # head_dim 64
        causal_prefill_splash(qb[..., :64].contiguous(),
                              qb[:, :, :2, :64].contiguous(),
                              qb[:, :, :2, :64].contiguous())
    # contiguous, but 2 bytes past a 16-byte boundary: TMA cannot map it
    flat = torch.zeros(1 + 64 * 2 * 128, device="cuda", dtype=torch.bfloat16)
    kv = flat[1:].view(1, 64, 2, 128)
    with pytest.raises(ValueError, match="16-byte"):
        causal_prefill_splash(qb[:, :, :2].contiguous(), kv, kv)


@pytest.mark.parametrize("kernel", ["F", "G"])
def test_vs_wrappers_refuse_what_the_kernels_do_not_take(gen, kernel):
    """F and G: f32 q/k/v, head_dim 64 and a q/k/v two bytes past a 16-byte
    boundary (TMA cannot map it) raise; the well-formed call runs."""
    block, s_pad, seq_len = 128, 256, 256
    if kernel == "F":
        q, k, v, v_idx, dflag, kv_map = _vs_tile_args(gen, block, s_pad,
                                                      seq_len)

        def run(q, k, v):
            return vs_tile_attention(q, k, v, v_idx, dflag, kv_map,
                                     block=block, scale=0.1, seq_len=seq_len)
    else:
        args, _ = _vs_sparse_args(gen, block, s_pad, seq_len)
        q, k, v = args[:3]

        def run(q, k, v):
            return vs_sparse_attention(q, k, v, *args[3:], block=block,
                                       scale=0.1, seq_len=seq_len)
    with pytest.raises(ValueError):
        run(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        run(q[..., :64].contiguous(), k[..., :64].contiguous(),
            v[..., :64].contiguous())
    flat = torch.zeros(1 + k.numel(), device="cuda", dtype=torch.bfloat16)
    k_off = flat[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        run(q, k_off, v)
    run(q, k, v)
    torch.cuda.synchronize()

"""The port's CUDA kernels against their plain versions on the card, at
small shapes. These need an NVIDIA GPU and skip without one; on the GPU
machine run ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: K rows within 2 bf16 ulps of the largest value (f32 sums in
another order, one bf16 rounding; a skipped chunk is shown to fail it);
int8 V rows exact; gathered chunks
bit-equal (the gather moves bytes only); attention outputs within 2^-6 of
each row's largest value, per (b, s, h) row, since the output's scale falls
with the row index (bf16 probabilities and one bf16 rounding give a few
2^-9), also for B's query-offset form (the sequence-parallel prefill's
attention), where the bound rejects the same rows placed 64 keys early;
the sparse prefill kernels (C, F, G) are held to the same per-row
bound on the rows below ``seq_len``, also at head_dim 96 and 64 (zero-padded
to 128 by the wrappers). The attention kernels (B, C, F, G)
give one batch row alone the same bits as that row inside a batch. The
refresh and the gather run with the V store on the card and pinned in host
memory. The compiled decode step (CUDA graphs) on a toy bf16 engine: for
each decode path, steps through the graph give the eager steps' tokens and
bit-equal cache state; kernel launches are counted through replays;
sampling inside the graph draws new numbers at every replay; 'auto'
captures both paths; the HostVStore path (miss-only V gather from the
pinned store) and the segmented decode attention are among the paths;
``utils/profiling.program_table`` gives one row per replayed graph. int8
weight quantization (``core/wquant.py``) on the card equals the host's bit
for bit. C, F and G at a tp=2 rank's head slice (Llama's 16 query / 4 KV
heads) match their plain versions per row and give bit for bit the head
slice of the same kernel over all heads. A tp-shaped cache saved on the
card loads on the CPU bit-equal, whole and as each tp rank's head
slice. A training step of the tiny trainer on the card equals the CPU's.
The decode-attention kernel matches its plain version per row as B does, at
the decode cells' buffer, S_new 4, G 7, head_dims 96 and 32, a tp rank's
2 KV heads and the full cache's 32K rows (scores in shared memory and
spilled to scratch); the check rejects P left unnormalised and a skipped
key tile; the wrapper refuses f32 q and a non-contiguous buffer; and every
graph path but the segmented ones launches it once per layer and step
through the replays, never the plain version. Kernel A's no-RoPE branch
(K-EXAONE's NoPE global layers) matches its plain version at that cell's
shape, and K-EXAONE's hybrid step (rings, experts, ShadowKV on the global
layers) replays as its eager steps run. The selection kernel's chosen sets
equal its plain version's outside near-ties (plain probs within
SELECT_TIE_TOL = 1e-6 of the S-th, relative) and its slot assignment is
``assign_slots_stable``'s for them bit for bit, at the three decode cells'
layers (bf16 and int8 with row scales), tp shards of 2 and 1 KV heads,
G * Q up to 32, head_dims 96 and 32, a 1M-context C whose scores spill to
scratch, under hysteresis and forced ids; ties go in ascending id and never
to an outlier; the check rejects the S-th chunk swapped for the (S+1)-th,
one stay flag flipped and an outlier chosen; the wrapper refuses what the
kernel does not take; and every ShadowKV graph path launches it once per
layer and step through the replays, never the plain version."""

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
from shadowkv_tpu_torch.core.selection import (
    assign_slots_stable,
    compact_misses,
    landmark_probs,
)
from shadowkv_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
    plan as decode_attention_plan,
)
from shadowkv_tpu_torch.kernels.gather import (
    gather_chunks,
    gather_chunks_plain,
    gather_v_rows,
    gather_v_rows_plain,
)
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_offset,
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


def _miss_lists(gen, b, kh, c, s):
    """Miss lists of one layer: per (b, kv head) in turn all hits, all
    misses scattered, all misses in one contiguous run of chunk ids, and
    half the slots kept."""
    dev = "cuda"
    prev = torch.stack([torch.randperm(c, device=dev, generator=gen)[:s]
                        for _ in range(b * kh)]).reshape(b, kh, s).int()
    new = prev.clone()
    for bk in range(b * kh):
        b_, k_ = divmod(bk, kh)
        others = torch.randperm(c, device=dev, generator=gen)
        others = others[~torch.isin(others, prev[b_, k_].long())].int()
        kind = bk % 4
        if kind == 1:
            new[b_, k_] = others[:s]
        elif kind == 2:
            run = torch.arange(5, 5 + s, device=dev, dtype=torch.int32)
            prev[b_, k_] = run + s
            new[b_, k_] = run
        elif kind == 3:
            new[b_, k_] = torch.cat([prev[b_, k_][:s // 2],
                                     others[:s - s // 2]])
    asg = assign_slots_stable(prev, new)
    return compact_misses(asg.slot_ids, asg.stay_mask)


def _refresh_case(gen, quant, style, cs, rank, kh=4):
    """Stores, buffers and miss lists of a two-layer refresh (layer 1 is
    refreshed), with the kwargs of sparse_refresh."""
    l, b, c, dh, s = 2, 2, 64, 128, 16
    dev = "cuda"
    u = torch.randn(l, b, c * cs, rank, device=dev, generator=gen).bfloat16()
    v = torch.randn(l, b, kh, c * cs, dh, device=dev, generator=gen).bfloat16()
    sv = (0.05 * torch.randn(l, b, kh, rank, dh, device=dev,
                             generator=gen)).bfloat16()
    u_sc = v_sc = None
    if quant:
        u, u_sc = quantize_store(u)
        v, v_sc = quantize_store(v)
    cap = 32 + s * cs + 16
    k_buf = torch.randn(l, b, kh, cap, dh, device=dev, generator=gen).bfloat16()
    v_buf = torch.randn(l, b, kh, cap, dh, device=dev, generator=gen).bfloat16()
    mc, ms, cnt = _miss_lists(gen, b, kh, c, s)
    rope_dim = 64 if style == "glm" else dh
    inv = torch.zeros(dh, device=dev)
    invf = 1.0 / 10000.0 ** (torch.arange(0, rope_dim, 2, device=dev) / rope_dim)
    if style == "glm":
        inv[:rope_dim] = torch.repeat_interleave(invf, 2)
    else:
        inv = torch.cat([invf, invf])
    kw = dict(chunk_size=cs, sparse_start=32, rope_dim=rope_dim,
              rope_style=style, u_scale=u_sc, v_scale=v_sc)
    return (mc, ms, cnt, u, sv, v, inv), k_buf, v_buf, kw


def _refresh_agrees(k_buf, v_buf, k_ref, v_ref):
    """A's check: K within 2 bf16 ulps of the largest K value, V bit-equal."""
    k_ok = float((k_buf.float() - k_ref.float()).abs().max()) \
        <= _bf16_tol(k_ref)
    return k_ok, torch.equal(v_buf, v_ref)


# (int8 stores, rope style, chunk size, rank, V pinned on the host): ranks
# 72, 100 and 8 exercise the padding of rank to a multiple of 16 and the
# 8- and 4-byte U row copies; chunk sizes 8-64 the rows of a block that
# span several chunks or part of one.
REFRESH_CASES = [
    (True, "neox", 16, 160, False), (False, "neox", 16, 160, False),
    (True, "neox", 16, 72, False), (False, "neox", 16, 72, False),
    (True, "neox", 16, 100, False), (False, "neox", 16, 100, False),
    (True, "neox", 16, 8, False), (False, "neox", 16, 8, False),
    (True, "neox", 8, 160, False), (False, "neox", 8, 96, False),
    (True, "neox", 32, 160, False), (True, "neox", 64, 160, False),
    (True, "glm", 16, 160, False), (False, "glm", 16, 160, False),
    (True, "glm", 32, 72, False), (True, "glm", 8, 96, False),
    (True, "neox", 16, 160, True), (False, "neox", 16, 160, True),
    (True, "neox", 32, 100, True), (True, "glm", 16, 160, True),
    (True, "neox", 8, 96, True), (False, "neox", 64, 72, True),
]


@pytest.mark.parametrize("quant, style, cs, rank, host_v", REFRESH_CASES)
def test_refresh_kernel_matches_plain(gen, quant, style, cs, rank, host_v):
    args, k_buf, v_buf, kw = _refresh_case(gen, quant, style, cs, rank)
    k_ref, v_ref = k_buf.clone(), v_buf.clone()
    sparse_refresh_plain(1, *args, k_ref, v_ref, **kw)
    mc, ms, cnt, u, sv, v, inv = args
    v_in = v.cpu().pin_memory() if host_v else v
    before = (sparse_refresh.launches, sparse_refresh.host_launches)
    sparse_refresh(1, mc, ms, cnt, u, sv, v_in, inv, k_buf, v_buf, **kw)
    torch.cuda.synchronize()
    assert (sparse_refresh.launches, sparse_refresh.host_launches) == (
        before[0] + 1, before[1] + int(host_v))
    assert _refresh_agrees(k_buf, v_buf, k_ref, v_ref) == (True, True)


@pytest.mark.parametrize("quant", [False, True])
def test_refresh_kernel_no_rope_matches_plain(gen, quant):
    """Kernel A's no-RoPE branch (a NoPE layer's keys: K-EXAONE's global
    layers) at the hybrid cell's shape, 8 KV heads, rank 160, chunk 8,
    against its plain version; a rotating kernel fails the same check."""
    args, k_buf, v_buf, kw = _refresh_case(gen, quant, "none", 8, 160, kh=8)
    k_ref, v_ref = k_buf.clone(), v_buf.clone()
    sparse_refresh_plain(1, *args, k_ref, v_ref, **kw)
    k_neox, v_neox = k_buf.clone(), v_buf.clone()
    sparse_refresh(1, *args, k_buf, v_buf, **kw)
    sparse_refresh(1, *args, k_neox, v_neox, **dict(kw, rope_style="neox"))
    torch.cuda.synchronize()
    assert _refresh_agrees(k_buf, v_buf, k_ref, v_ref) == (True, True)
    assert _refresh_agrees(k_neox, v_neox, k_ref, v_ref) == (False, True)


@pytest.mark.parametrize("host_v", [False, True])
def test_refresh_check_rejects_a_skipped_chunk(gen, host_v):
    """A kernel told to skip each head's last missed chunk (its count one
    short) fails both halves of the check against the plain version of
    the whole list: the tolerance catches a missing chunk."""
    args, k_buf, v_buf, kw = _refresh_case(gen, True, "neox", 16, 160)
    k_ref, v_ref = k_buf.clone(), v_buf.clone()
    sparse_refresh_plain(1, *args, k_ref, v_ref, **kw)
    mc, ms, cnt, u, sv, v, inv = args
    short = (cnt - (cnt > 0).int()).contiguous()
    v_in = v.cpu().pin_memory() if host_v else v
    sparse_refresh(1, mc, ms, short, u, sv, v_in, inv, k_buf, v_buf, **kw)
    torch.cuda.synchronize()
    assert _refresh_agrees(k_buf, v_buf, k_ref, v_ref) == (False, False)


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


@pytest.mark.parametrize("s_q, t_k, offset, g", [
    (128, 256, 128, 4), (100, 300, 150, 2), (256, 1000, 744, 8),
    (72, 72, 0, 1), (1, 129, 128, 4), (200, 1000, 300, 4), (64, 4104, 4040, 2),
])
def test_prefill_attention_offset_kernel_matches_plain(gen, s_q, t_k, offset,
                                                       g):
    """Kernel B's offset form: S_q rows at key positions [offset, offset +
    S_q) of T_k keys, per-row bound as B; the bound rejects the rows
    attended 64 positions early (a wrong offset)."""
    kh, dh = 2, 128
    q = torch.randn(2, s_q, kh * g, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, t_k, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, t_k, kh, dh, device="cuda", generator=gen).bfloat16()
    ref = causal_prefill_attention(q, k, v, offset=offset)
    before = causal_prefill_offset.launches
    out = causal_prefill_offset(q, k, v, offset)
    torch.cuda.synchronize()
    assert causal_prefill_offset.launches == before + 1
    assert _row_rel_err(out, ref) <= 2.0**-6
    if offset >= 64:
        early = causal_prefill_attention(q, k, v, offset=offset - 64)
        assert _row_rel_err(out, early) > 2.0**-6


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


@pytest.mark.parametrize("dh", [96, 64])
@pytest.mark.parametrize("s, window, sink", [(1000, None, None),
                                             (200, None, None),
                                             (1000, 300, 129)])
def test_prefill_kernels_take_head_dim_below_128(gen, s, window, sink, dh):
    """B and C at head_dim 96 (Phi-3) and 64: the wrapper zero-pads q, k
    and v to 128, keeps the softmax scale of the true head_dim and slices
    the output back; held to the plain versions per row."""
    kh, g = 2, 4
    q = torch.randn(2, s, kh * g, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, s, kh, dh, device="cuda", generator=gen).bfloat16()
    if window is None:
        ref = causal_prefill_attention(q, k, v)
        out = causal_prefill_splash(q, k, v)
    else:
        ref = sparse_prefill_attention(q, k, v, window, sink)
        out = sparse_prefill_splash(q, k, v, window, sink)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
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


def _vs_inputs(gen, b=2, h=4, kh=2, s_pad=512, dh=128):
    q = torch.randn(b * h, s_pad, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b * kh, s_pad, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b * kh, s_pad, dh, device="cuda", generator=gen).bfloat16()
    kv_map = ((torch.arange(b)[:, None] * kh
               + torch.arange(h)[None, :] // (h // kh)).reshape(-1)
              .int().cuda())
    return q, k, v, kv_map


# (block, S_pad, seq_len): blocks {64, 128, 256} x ragged seq_len at S_pad
# 512, S_pad a multiple of 64 but not of 128, and a block that is a
# multiple of 64 but not a power of two.
VS_CASES = [(block, 512, seq_len) for block in (64, 128, 256)
            for seq_len in (512, 459, 333)] + [(64, 448, 391), (192, 576, 500)]


def _vs_tile_args(gen, block, s_pad, seq_len, b=2, dh=128):
    q, k, v, kv_map = _vs_inputs(gen, b=b, s_pad=s_pad, dh=dh)
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


def _vs_sparse_args(gen, block, s_pad, seq_len, b=2, dh=128):
    q, k, v, kv_map = _vs_inputs(gen, b=b, s_pad=s_pad, dh=dh)
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


@pytest.mark.parametrize("dh", [96, 64])
@pytest.mark.parametrize("kernel", ["F", "G"])
@pytest.mark.parametrize("block, s_pad, seq_len", [(64, 448, 391),
                                                   (128, 512, 512)])
def test_vs_kernels_take_head_dim_below_128(gen, kernel, block, s_pad,
                                            seq_len, dh):
    """F and G at head_dim 96 and 64 (zero-padded to 128 by the wrapper,
    softmax scale of the true head_dim) against their plain versions."""
    kw = dict(block=block, scale=dh**-0.5, seq_len=seq_len)
    if kernel == "F":
        q, k, v, v_idx, dflag, kv_map = _vs_tile_args(gen, block, s_pad,
                                                      seq_len, dh=dh)
        ref = vs_tok_attention_reference(q, k, v, v_idx, dflag, kv_map, **kw)
        out = vs_tile_attention(q, k, v, v_idx, dflag, kv_map, **kw)
    else:
        args, meta = _vs_sparse_args(gen, block, s_pad, seq_len, dh=dh)
        q, k, v, kv_map = args[0], args[1], args[2], args[-1]
        ref = vs_attention_reference(q, k, v, meta, kv_map, **kw)
        out = vs_sparse_attention(*args, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
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


@pytest.mark.parametrize("host_v", [False, True])
def test_gather_v_rows_matches_plain(gen, host_v):
    """The miss-only V gather (the HostVStore path): the rows of every slot
    that missed bit-equal to the plain version's, about half of the slots
    staying (their rows are unspecified)."""
    ids, _, v, _, _ = _gather_inputs(gen, False)
    stay = torch.rand(ids.shape, device="cuda", generator=gen) < 0.5
    ref = gather_v_rows_plain(1, ids, stay, v, chunk_size=16)
    v_in = v.cpu().pin_memory() if host_v else v
    before = gather_v_rows.launches
    out = gather_v_rows(1, ids, stay, v_in, chunk_size=16)
    torch.cuda.synchronize()
    assert gather_v_rows.launches == before + 1
    assert out.shape == ids.shape + (16, 128) and out.is_cuda
    miss = ~stay
    assert torch.equal(out[miss], ref[miss]) and miss.any() and stay.any()
    with pytest.raises(ValueError, match="pinned"):
        gather_v_rows(1, ids, stay, v.cpu(), chunk_size=16)
    with pytest.raises(ValueError, match="bool"):
        gather_v_rows(1, ids, stay.int(), v_in, chunk_size=16)


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
    # head_dim 64 is zero-padded to 128 and matches the plain version
    q64, kv64 = qb[..., :64].contiguous(), qb[:, :, :2, :64].contiguous()
    out = causal_prefill_splash(q64, kv64, kv64)
    torch.cuda.synchronize()
    assert _row_rel_err(out, causal_prefill_attention(q64, kv64, kv64)) \
        <= 2.0**-6
    q160 = torch.randn(1, 64, 4, 160, device="cuda", generator=gen).bfloat16()
    with pytest.raises(ValueError, match="head_dim <= 128"):
        causal_prefill_splash(q160, q160[:, :, :2].contiguous(),
                              q160[:, :, :2].contiguous())
    # contiguous, but 2 bytes past a 16-byte boundary: TMA cannot map it
    flat = torch.zeros(1 + 64 * 2 * 128, device="cuda", dtype=torch.bfloat16)
    kv = flat[1:].view(1, 64, 2, 128)
    with pytest.raises(ValueError, match="16-byte"):
        causal_prefill_splash(qb[:, :, :2].contiguous(), kv, kv)


@pytest.mark.parametrize("kernel", ["F", "G"])
def test_vs_wrappers_refuse_what_the_kernels_do_not_take(gen, kernel):
    """F and G: f32 q/k/v, head_dim 160 (above the kernels' 128) and a
    q/k/v two bytes past a 16-byte boundary (TMA cannot map it) raise; the
    well-formed call runs."""
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
    with pytest.raises(ValueError, match="head_dim <= 128"):
        run(*(torch.cat([t, t[..., :32]], dim=-1) for t in (q, k, v)))
    flat = torch.zeros(1 + k.numel(), device="cuda", dtype=torch.bfloat16)
    k_off = flat[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        run(q, k_off, v)
    run(q, k, v)
    torch.cuda.synchronize()


# -- decode attention (kernels/decode_attention.py) -------------------------

# (B, K, G, T_cap, head_dim, S_new, kv_len): "slots" a [B] kv_len of depths
# that differ (one at T_cap), "scalar" one 0-d kv_len, "short" [B] with one
# row's kv_len below S_new (the plain version's uniform weights)
DECODE_CASES = [
    (8, 4, 8, 2624, 128, 1, "slots"),  # the glm4 decode cell's buffer
    (8, 4, 8, 2624, 128, 1, "scalar"),
    (8, 4, 8, 2624, 128, 4, "slots"),  # S_new 4: two row groups
    (2, 4, 7, 2624, 128, 1, "slots"),  # G 7 (Qwen2-7B)
    (2, 8, 1, 1000, 96, 1, "slots"),  # head_dim 96 at G 1 (Phi-3)
    (2, 2, 2, 544, 32, 1, "slots"),  # head_dim 32 at G 2 (the toy model)
    (2, 2, 2, 544, 32, 4, "short"),
    (8, 2, 8, 2624, 128, 1, "slots"),  # K 2: a tp rank's heads
    (2, 4, 8, 32832, 128, 1, "slots"),  # the full cache, scores in smem
    (8, 4, 8, 32832, 128, 1, "slots"),  # the full cache, scores spilled
]


def _decode_case(gen, b, kh, g, t, dh, s_new, lens):
    q = torch.randn(b, s_new, kh * g, dh, device="cuda",
                    generator=gen).bfloat16()
    k = torch.randn(b, kh, t, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, kh, t, dh, device="cuda", generator=gen).bfloat16()
    if lens == "scalar":
        return q, k, v, torch.tensor(t - 77, dtype=torch.int32, device="cuda")
    kv_len = torch.randint(s_new, t + 1, (b,), device="cuda", generator=gen,
                           dtype=torch.int32)
    kv_len[0] = t
    if lens == "short":
        kv_len[-1] = s_new - 2
    return q, k, v, kv_len


def _decode_fault(q, k, v, kv_len, fault):
    """The plain math with a planted fault: P left unnormalised, or the
    keys 1024-1087 (one 64-row tile) skipped."""
    b, s_new, h, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, s_new, kh, h // kh, dh).float()
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) * dh**-0.5
    pos_k = torch.arange(t, device=q.device)
    q_abs = kv_len.reshape(-1, 1) - s_new + torch.arange(s_new,
                                                         device=q.device)
    keep = (pos_k <= q_abs[..., None])[:, None, None]
    if fault == "skipped_tile":
        keep = keep & ((pos_k < 1024) | (pos_k >= 1088))
    scores = torch.where(keep, scores, -torch.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    if fault != "unnormalised":
        p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bskgd", p.bfloat16().float(), v.float())
    return out.reshape(b, s_new, h, dh).bfloat16()


@pytest.mark.parametrize("b, kh, g, t, dh, s_new, lens", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(gen, b, kh, g, t, dh, s_new,
                                               lens):
    """Per (b, s, h) row within 2^-6 of the row's largest |value|, as B; a
    second call gives the same bits (every sum in a fixed order)."""
    q, k, v, kv_len = _decode_case(gen, b, kh, g, t, dh, s_new, lens)
    ref = decode_attention_plain(q, k, v, kv_len)
    before = decode_attention.launches
    out = decode_attention(q, k, v, kv_len)
    again = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)
    assert _row_rel_err(out, ref) <= 2.0**-6


def test_decode_attention_spills_scores_past_shared_memory(gen):
    """The full cache's ranges: at B 2 x 4 KV heads (8 CTAs a cluster) the
    scores of a 4160-key range fit in shared memory, at B 8 (4 CTAs, 8256
    keys) they go to the wrapper's scratch; both cases run above."""
    assert decode_attention_plan(2, 4, 8, 32832, 128).scratch_floats == 0
    assert decode_attention_plan(8, 4, 8, 32832, 128).scratch_floats > 0
    glm4 = decode_attention_plan(8, 4, 8, 2624, 128)
    assert glm4.scratch_floats == 0 and glm4.row_groups == 1


@pytest.mark.parametrize("fault", ["unnormalised", "skipped_tile"])
def test_decode_attention_check_rejects_a_planted_fault(gen, fault):
    """At the glm4 cell's shape the per-row check passes the kernel and
    fails the plain math with P left unnormalised or one key tile
    skipped."""
    q, k, v, kv_len = _decode_case(gen, 8, 4, 8, 2624, 128, 1, "slots")
    ref = decode_attention_plain(q, k, v, kv_len)
    out = decode_attention(q, k, v, kv_len)
    bad = _decode_fault(q, k, v, kv_len, fault)
    torch.cuda.synchronize()
    assert _row_rel_err(out, ref) <= 2.0**-6 < _row_rel_err(bad, ref)


def test_decode_attention_refuses_what_the_kernel_does_not_take(gen):
    """f32 q on the card, a non-contiguous buffer, head_dim 40 and a kv_len
    of the wrong length raise; the well-formed call runs."""
    q, k, v, kv_len = _decode_case(gen, 2, 2, 4, 256, 128, 1, "slots")
    with pytest.raises(ValueError, match="bf16"):
        decode_attention(q.float(), k, v, kv_len)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k[:, :, :128], v[:, :, :128], kv_len)
    with pytest.raises(ValueError, match="multiple of 16"):
        decode_attention(q[..., :40], k[..., :40].contiguous(),
                         v[..., :40].contiguous(), kv_len)
    with pytest.raises(ValueError, match="0-d or"):
        decode_attention(q, k, v, torch.cat([kv_len, kv_len]))
    decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()


# -- landmark selection (kernels/select.py) ---------------------------------

# A chunk whose plain prob lies within SELECT_TIE_TOL of the S-th prob
# (relative) is a near-tie that either side may take: the kernel's f32 sums
# of the scores, the softmax's sums and the (max, sum) merge over the
# cluster run in another order than the plain version's (cuBLAS, torch's
# softmax), a few f32 ulps of each prob. Every other chunk is chosen by both
# or by neither.
SELECT_TIE_TOL = 1e-6

# (B, K, G, Q, C, S, head_dim, int8)
SELECT_CASES = {
    "glm4": (8, 4, 8, 1, 4088, 256, 128, False),
    "yi int8": (8, 4, 8, 1, 4088, 256, 128, True),
    "k-exaone": (8, 8, 8, 1, 4088, 256, 128, False),
    "tp2 K2": (8, 2, 8, 1, 4088, 256, 128, False),
    "tp4 K1": (8, 1, 8, 1, 4088, 256, 128, False),
    "G8 Q4": (2, 4, 8, 4, 4088, 256, 128, False),
    "G7 Q3 dh96": (2, 2, 7, 3, 1000, 64, 96, True),
    "toy dh32": (2, 2, 2, 1, 24, 8, 32, False),
    "past smem": (1, 4, 8, 1, 131064, 2048, 128, True),
}


def _select_case(gen, b, kh, g, qn, c, s, dh, int8):
    """q as the decode layer passes it (a view of [B, Q, H, Dh]), random
    landmarks (int8 with row scales), ~5 % outliers, and previous ids that
    overlap the new choice: the plain selection for a nearby query."""
    from shadowkv_tpu_torch.core.quant import quantize_rows
    from shadowkv_tpu_torch.core.selection import score_and_select

    q_flat = torch.randn(b, qn, kh * g, dh, device="cuda", generator=gen)
    q = q_flat.bfloat16().transpose(1, 2).reshape(b, kh, g, qn, dh)
    lm = torch.randn(b, kh, c, dh, device="cuda", generator=gen).bfloat16()
    scale = None
    if int8:
        lm, scale = quantize_rows(lm)
    mask = torch.rand(b, kh, c, device="cuda", generator=gen) > 0.05
    near = q.float() + torch.randn(q.shape, device="cuda", generator=gen)
    prev = score_and_select(near.bfloat16(), lm, mask, s,
                            landmark_scale=scale)
    return q, lm, mask, prev, scale


def _selection_agrees(asg, probs, prev, s, forced=None) -> bool:
    """The kernel's chosen set (its slot ids) is S distinct chunks equal to
    the plain top-S outside near-ties (or to the forced ids), and its slot
    ids, stay flags and count are ``assign_slots_stable``'s for that set,
    bit for bit."""
    ids = asg.slot_ids.long()
    c = probs.shape[-1]
    if not bool(((ids >= 0) & (ids < c)).all()):
        return False
    got = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, ids, True)
    if not bool((got.sum(-1) == s).all()):
        return False
    if forced is not None:
        want = torch.zeros_like(got).scatter_(
            -1, forced.long().expand_as(ids), True)
        ok = torch.equal(got, want)
    else:
        top = torch.topk(probs, s)
        want = torch.zeros_like(got).scatter_(-1, top.indices, True)
        t = top.values[..., -1:]
        near = (probs - t).abs() <= SELECT_TIE_TOL * t
        ok = not bool(((got ^ want) & ~near).any())
    ref = assign_slots_stable(prev, asg.slot_ids)
    return ok and torch.equal(asg.slot_ids, ref.slot_ids) \
        and torch.equal(asg.stay_mask, ref.stay_mask) \
        and torch.equal(asg.stay_count, ref.stay_count)


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_kernel_matches_plain(gen, name):
    """The chosen sets equal the plain version's outside near-ties, the
    assignment is bit-equal for them, a second call gives the same bits,
    and each call is one launch."""
    from shadowkv_tpu_torch.kernels.select import select_slots

    b, kh, g, qn, c, s, dh, int8 = SELECT_CASES[name]
    q, lm, mask, prev, scale = _select_case(gen, *SELECT_CASES[name])
    before = select_slots.launches
    asg = select_slots(q, lm, mask, prev, s, landmark_scale=scale)
    again = select_slots(q, lm, mask, prev, s, landmark_scale=scale)
    torch.cuda.synchronize()
    assert select_slots.launches == before + 2
    for a, b_ in zip(asg, again):
        assert torch.equal(a, b_)
    probs = landmark_probs(q, lm, mask, scale)
    assert _selection_agrees(asg, probs, prev, s)
    assert 0 < int(asg.stay_count.sum()) < asg.stay_mask.numel()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["hysteresis", "forced"])
def test_select_kernel_hysteresis_and_forced_ids(gen, kind, int8):
    """At the glm4 cell's shape: hysteresis 0.3 on the previous ids, and
    forced ids (the benchmark-only ``debug_hit_rate`` window) in place of
    the chosen set; forced, the outputs equal the plain version's bit for
    bit."""
    from shadowkv_tpu_torch.cache.shadow import ShadowLayout
    from shadowkv_tpu_torch.cache.shadow import forced_ids as make_forced
    from shadowkv_tpu_torch.config import CacheConfig
    from shadowkv_tpu_torch.kernels.select import (
        select_slots,
        select_slots_plain,
    )

    b, kh, g, qn, c, s, dh, _ = SELECT_CASES["glm4"]
    q, lm, mask, prev, scale = _select_case(gen, b, kh, g, qn, c, s, dh, int8)
    hyst, forced = 0.0, None
    if kind == "hysteresis":
        hyst = 0.3
    else:
        lay = ShadowLayout.build(CacheConfig(
            mode="shadow", sparse_budget=2048, chunk_size=8, local_chunks=4,
            outlier_chunks=48), 32768)
        assert (lay.chunks, lay.select_sets) == (c, s)
        forced = make_forced(lay, torch.tensor(5, device="cuda"), 0.6,
                             "scatter", "cuda")
    asg = select_slots(q, lm, mask, prev, s, landmark_scale=scale,
                       hysteresis=hyst, forced_ids=forced)
    torch.cuda.synchronize()
    probs = landmark_probs(q, lm, mask, scale, prev, hyst)
    assert _selection_agrees(asg, probs, prev, s, forced)
    if forced is not None:
        ref = select_slots_plain(q, lm, mask, prev, s, landmark_scale=scale,
                                 forced_ids=forced)
        for a, b_ in zip(asg, ref):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("fault", ["swap S-th", "stay flipped", "outlier"])
def test_select_check_rejects_a_planted_fault(gen, fault):
    """At the glm4 cell's shape the check passes the kernel and fails its
    output with the S-th chunk swapped for the (S+1)-th, one stay flag
    flipped, or an outlier chunk in place of a chosen one."""
    from shadowkv_tpu_torch.kernels.select import select_slots

    b, kh, g, qn, c, s, dh, int8 = SELECT_CASES["glm4"]
    q, lm, mask, prev, scale = _select_case(gen, *SELECT_CASES["glm4"])
    asg = select_slots(q, lm, mask, prev, s, landmark_scale=scale)
    probs = landmark_probs(q, lm, mask, scale)
    assert _selection_agrees(asg, probs, prev, s)
    slot_ids, stay = asg.slot_ids.clone(), asg.stay_mask.clone()
    row = slot_ids[0, 0]
    if fault == "swap S-th":
        order = torch.argsort(probs[0, 0], descending=True)
        row[row == order[s - 1]] = order[s].int()
    elif fault == "stay flipped":
        stay[0, 0, 0] = ~stay[0, 0, 0]
    else:
        row[0] = torch.nonzero(~mask[0, 0])[0, 0].int()
    bad = asg._replace(slot_ids=slot_ids, stay_mask=stay)
    assert not _selection_agrees(bad, probs, prev, s)


def test_select_kernel_tie_rule(gen):
    """Exact ties: chunks of equal prob are taken in ascending id, and an
    outlier (prob 0) is never taken over an unmasked chunk whose prob
    underflowed to 0. Ten chunks hold the weight, the other unmasked ones
    underflow, the ids below `lo` are outliers: S 20 takes the ten and ids
    lo .. lo + 9. At C 4088 the ranges are split over a cluster of 8 CTAs
    of 512 chunks, and the ties cross from the second CTA into the third."""
    from shadowkv_tpu_torch.kernels.select import plan, select_slots

    for c, lo in ((300, 100), (4088, 1020)):
        b, kh, g, dh, s = 2, 2, 4, 128, 20
        v = torch.ones(dh, device="cuda")
        q = (8 * v).expand(b, kh, g, 1, dh).bfloat16()
        lm = (-8 * v).expand(b, kh, c, dh).clone()
        lm[:, :, c - 50:c - 40] = 8 * v
        lm = lm.bfloat16()
        mask = torch.ones(b, kh, c, dtype=torch.bool, device="cuda")
        mask[:, :, :lo] = False
        prev = torch.arange(s, dtype=torch.int32, device="cuda").expand(
            b, kh, s).contiguous()
        asg = select_slots(q, lm, mask, prev, s)
        torch.cuda.synchronize()
        want = list(range(lo, lo + 10)) + list(range(c - 50, c - 40))
        for row in asg.slot_ids.reshape(-1, s):
            assert sorted(row.tolist()) == want
        if c == 4088:
            p = plan(b, kh, g, c, s, dh, False)
            assert (p.cluster, p.per) == (8, 512)


def test_select_refuses_what_the_kernel_does_not_take(gen):
    """f32 q, a non-contiguous table, head_dim 40, int64 previous ids,
    forced ids of another shape and S above C raise; the well-formed call
    runs."""
    from shadowkv_tpu_torch.kernels.select import select_slots

    q, lm, mask, prev, _ = _select_case(gen, 2, 2, 4, 1, 300, 16, 128, False)
    with pytest.raises(ValueError, match="bf16"):
        select_slots(q.float(), lm, mask, prev, 16)
    with pytest.raises(ValueError, match="contiguous"):
        select_slots(q, lm[:, :, :200], mask[:, :, :200], prev, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        select_slots(q[..., :40], lm[..., :40].contiguous(), mask, prev, 16)
    with pytest.raises(ValueError, match="int32"):
        select_slots(q, lm, mask, prev.long(), 16)
    with pytest.raises(ValueError, match="forced_ids"):
        select_slots(q, lm, mask, prev, 16,
                     forced_ids=prev[0].contiguous())
    with pytest.raises(ValueError, match="select_sets"):
        select_slots(q, lm, mask, prev, 301)
    select_slots(q, lm, mask, prev, 16)
    torch.cuda.synchronize()


# -- the compiled decode step (CUDA graphs) on a toy bf16 engine ------------

# path -> (cache mode, runtime settings, the decode kernel's counters)
GRAPH_PATHS = {
    "fused": ("shadow", dict(use_pallas=True), ("launches",)),
    "xla-gather": ("shadow", dict(use_pallas=None), ()),
    "ring": ("shadow", dict(ring_gather=True), ("launches",)),
    "offload-fused": ("shadow_offload", dict(use_pallas=True),
                      ("launches", "host_launches")),
    "offload-ring": ("shadow_offload", dict(ring_gather=True),
                     ("launches", "host_launches")),
    "full": ("full", dict(), ()),
    # the HostVStore path (bf16 stores: kv_quant 'none')
    "offload-host": ("shadow_offload", dict(use_pallas=None), ("launches",)),
    "xla-gather-segmented": ("shadow", dict(decode_segmented=True), ()),
    "ring-segmented": ("shadow", dict(ring_gather=True,
                                      decode_segmented=True), ("launches",)),
}
BF16_STORE_PATHS = ("offload-host",)
GRAPH_STEPS = 6


def _toy_engine(mode, kv_quant="int8", **rt_kw):
    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config

    cfg = toy_config(dtype=torch.bfloat16, head_dim=128, hidden_size=512,
                     num_heads=4, num_kv_heads=2, intermediate_size=1024)
    params = init_synthetic_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), scale=0.2,
        device="cuda")
    cc = CacheConfig(mode=mode, max_length=544, sparse_budget=128, rank=64,
                     chunk_size=16, kv_quant=kv_quant, outlier_chunks=4,
                     gen_capacity=32)
    eng = Engine(cfg, cc, RuntimeConfig(**rt_kw), params, device="cuda")
    ids = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 512))
    return eng, ids


def _path_engine(path):
    mode, rt_kw, _ = GRAPH_PATHS[path]
    quant = "none" if path in BF16_STORE_PATHS else "int8"
    return _toy_engine(mode, kv_quant=quant, **rt_kw)


def _decode_kernel(path):
    if path in BF16_STORE_PATHS:
        return gather_v_rows
    return sparse_refresh if GRAPH_PATHS[path][1].get("use_pallas") \
        else gather_chunks


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_steps_equal_eager_steps(gen, path):
    """From one prefill, GRAPH_STEPS greedy steps through the compiled step
    (one eager step, the capture, replays) and as many eager ``_decode``
    steps on a copy of the cache's mutable state: the same kernels on the
    same inputs, so the same tokens and bit-equal cache state."""
    import dataclasses

    mode = GRAPH_PATHS[path][0]
    eng, ids = _path_engine(path)
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    names = ("k_buf", "v_buf", "cached_ids", "gen_len") if mode != "full" \
        else ("k", "v", "length")
    copy = dataclasses.replace(
        cache, **{n: getattr(cache, n).clone() for n in names})
    eager, t = [], tok
    for _ in range(GRAPH_STEPS):
        t = eng._decode(copy, t[:, None])[:, -1].argmax(-1).int()
        eager.append(t)
    zeros = torch.zeros(GRAPH_STEPS, 2, dtype=torch.int32, device="cuda")
    _, toks = eng.decode_chunk(cache, tok, zeros, zeros.bool())
    assert torch.equal(toks, torch.stack(eager).cpu())
    for n in names:
        assert torch.equal(getattr(cache, n), getattr(copy, n)), n
    assert len(eng._steps._graphs) == 1


@pytest.mark.parametrize("path", sorted(p for p, v in GRAPH_PATHS.items()
                                        if v[2]))
def test_launch_counts_through_replays(gen, path):
    """batch_generate's decode kernel launches counted through the graph's
    replays: once per layer and step, host-V launches likewise."""
    attrs = GRAPH_PATHS[path][2]
    eng, ids = _path_engine(path)
    fn = _decode_kernel(path)
    saved = {a: getattr(fn, a) for a in attrs}
    for a in attrs:
        setattr(fn, a, 0)
    try:
        eng.batch_generate(ids, gen_len=GRAPH_STEPS, temperature=0.0,
                           warmup_steps=2)
        counts = {a: getattr(fn, a) for a in attrs}
    finally:
        for a, v in saved.items():
            setattr(fn, a, getattr(fn, a) + v)
    want = eng.model.num_layers * (GRAPH_STEPS + 2)
    assert counts == dict.fromkeys(attrs, want)
    assert len(eng._steps._graphs) == 1


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_decode_attention_launches_through_replays(gen, path, monkeypatch):
    """batch_generate's decode attention counted through the graph's
    replays: one kernel launch per layer and step on every path but the
    segmented ones (their attention stays tensor code), and no call of
    the plain version."""
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA call reached decode_attention_plain")

    monkeypatch.setattr("shadowkv_tpu_torch.kernels.decode_attention."
                        "decode_attention_plain", plain)
    eng, ids = _path_engine(path)
    before = decode_attention.launches
    eng.batch_generate(ids, gen_len=GRAPH_STEPS, temperature=0.0,
                       warmup_steps=2)
    launched = decode_attention.launches - before
    segmented = GRAPH_PATHS[path][1].get("decode_segmented", False)
    assert launched == (0 if segmented
                        else eng.model.num_layers * (GRAPH_STEPS + 2))
    assert len(eng._steps._graphs) == 1


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_select_launches_through_replays(gen, path, monkeypatch):
    """batch_generate's selection counted through the graph's replays: one
    kernel launch per layer and step on every ShadowKV path (none on the
    full cache), and no call of the plain version."""
    from shadowkv_tpu_torch.kernels.select import select_slots

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA call reached select_slots_plain")

    monkeypatch.setattr("shadowkv_tpu_torch.kernels.select."
                        "select_slots_plain", plain)
    eng, ids = _path_engine(path)
    before = select_slots.launches
    eng.batch_generate(ids, gen_len=GRAPH_STEPS, temperature=0.0,
                       warmup_steps=2)
    launched = select_slots.launches - before
    full = GRAPH_PATHS[path][0] == "full"
    assert launched == (0 if full
                        else eng.model.num_layers * (GRAPH_STEPS + 2))
    assert len(eng._steps._graphs) == 1


def test_graph_sampling_draws_new_numbers(gen):
    """Temperature sampling inside the graph advances the generator at
    every replay: the replayed steps do not all repeat one token, and a
    second generator seeded alike gives the same tokens from the same
    state (the draws come from the generator, not from the capture)."""
    import dataclasses

    eng, ids = _toy_engine("shadow", use_pallas=True)
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    names = ("k_buf", "v_buf", "cached_ids", "gen_len")
    start = {n: getattr(cache, n).clone() for n in names}
    zeros = torch.zeros(GRAPH_STEPS, 2, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(2):
        for n in names:
            getattr(cache, n).copy_(start[n])
        g = torch.Generator(device="cuda").manual_seed(3)
        runs.append(eng.decode_chunk(cache, tok, zeros, zeros.bool(),
                                     generator=g, temperature=0.6)[1])
    assert (runs[0][2:] != runs[0][1:-1]).any()
    assert torch.equal(runs[0][1:], runs[1][1:])
    assert len(eng._steps._graphs) == 2  # one per generator


def test_auto_captures_both_paths(gen):
    """use_pallas='auto' at threshold 0.0: the warmup captures the
    XLA-gather and the fused graph, the EMA moves the engine onto the
    kernel, and the kernel's launches count only its replays' steps."""
    eng, ids = _toy_engine("shadow", use_pallas="auto",
                           pallas_hit_threshold=0.0, pallas_auto_interval=2)
    before = sparse_refresh.launches
    toks, _ = eng.batch_generate(ids, gen_len=GRAPH_STEPS, temperature=0.0,
                                 warmup_steps=2)
    launched = sparse_refresh.launches - before
    assert toks.shape == (2, GRAPH_STEPS)
    assert len(eng._steps._graphs) == 2
    assert eng._kernel_now and eng._auto_switches >= 1
    layers = eng.model.num_layers
    assert launched % layers == 0 and layers <= launched < layers * 8


def test_program_table_has_one_row_per_replayed_graph(gen, tmp_path):
    """``utils/profiling.program_table`` over a trace of GRAPH_STEPS
    replays of one captured decode step: one row, GRAPH_STEPS calls, the
    device time of the kernels those replays ran."""
    from shadowkv_tpu_torch.utils import profiling

    eng, ids = _toy_engine("shadow", use_pallas=True)
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    zeros = torch.zeros(GRAPH_STEPS, 2, dtype=torch.int32, device="cuda")
    # the eager step, the capture and the first replays
    tok, _ = eng.decode_chunk(cache, tok, zeros, zeros.bool())
    with profiling.trace(str(tmp_path)):
        eng.decode_chunk(cache, tok, zeros, zeros.bool())
    rows = profiling.program_table(str(tmp_path))
    assert len(eng._steps._graphs) == 1
    assert len(rows) == 1 and rows[0]["count"] == GRAPH_STEPS
    assert rows[0]["ms"] > 0


@pytest.mark.parametrize("shape, axis", [((3, 512, 384), -2), ((1000, 256), -1)])
def test_quantize_weight_card_equals_host(gen, shape, axis):
    """int8 weights quantized on the card equal the host's bit for bit (the
    HF loader quantizes on the host, ``quantize_params`` on the card)."""
    from shadowkv_tpu_torch.core.wquant import quantize_weight

    w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    dev = quantize_weight(w, reduce_axis=axis)
    host = quantize_weight(w.cpu(), reduce_axis=axis)
    assert torch.equal(dev.q.cpu(), host.q)
    assert torch.equal(dev.s.cpu(), host.s)


# -- a tp=2 rank's shard ----------------------------------------------------


def _tp2_flags(gen, b, h, s, block):
    """Vertical ids and band flags (F), block metadata (G) for ``b * h``
    heads."""
    bh, nk = b * h, s // block
    dflag = (torch.rand(bh, nk, device="cuda", generator=gen) < 0.3).int()
    dflag[:, 0] = 1
    v_idx = torch.randint(0, s, (bh, 200), device="cuda", generator=gen,
                          dtype=torch.int32)
    col = (torch.rand(bh, nk, device="cuda", generator=gen) < 0.3).int()
    return v_idx, dflag, meta_from_flags(col, dflag)


@pytest.mark.parametrize("kernel", ["C", "F", "G"])
def test_sparse_prefill_kernels_at_the_tp2_head_slice(gen, kernel):
    """Rank t=1 of tp=2 over 32 query / 8 KV heads holds heads [16, 32) /
    [4, 8): the kernel on that slice matches its plain version per row,
    and equals bit for bit the slice of the kernel over all heads."""
    b, s, h, kh, dh, block = 2, 1024, 32, 8, 128, 128
    q = torch.randn(b, s, h, dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, s, kh, dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, s, kh, dh, device="cuda", generator=gen).bfloat16()
    hs, ks = slice(h // 2, h), slice(kh // 2, kh)
    half = [t[:, :, sl].contiguous() for t, sl in ((q, hs), (k, ks), (v, ks))]
    if kernel == "C":
        out = sparse_prefill_splash(*half, 300, 64)
        ref = sparse_prefill_attention(*half, 300, 64)
        whole = sparse_prefill_splash(q, k, v, 300, 64)[:, :, hs]
    else:
        def flat(t):  # [B, S, N, Dh] -> [B * N, S, Dh]
            return t.transpose(1, 2).reshape(-1, s, dh).contiguous()

        def kv_map(n, nk):
            return ((torch.arange(b)[:, None] * nk
                     + torch.arange(n)[None, :] // (n // nk)).reshape(-1)
                    .int().cuda())

        v_idx, dflag, meta = _tp2_flags(gen, b, h, s, block)
        mine = torch.arange(b * h, device="cuda").view(b, h)[:, hs].reshape(-1)
        kw = dict(block=block, scale=dh**-0.5, seq_len=s)
        args = [flat(t) for t in half]
        if kernel == "F":
            out = vs_tile_attention(*args, v_idx[mine], dflag[mine],
                                    kv_map(h // 2, kh // 2), **kw)
            ref = vs_tok_attention_reference(*args, v_idx[mine], dflag[mine],
                                             kv_map(h // 2, kh // 2), **kw)
            full = vs_tile_attention(flat(q), flat(k), flat(v), v_idx, dflag,
                                     kv_map(h, kh), **kw)
        else:
            part = meta_from_flags(meta.col_flag[mine], dflag[mine])
            out = vs_sparse_attention(*args, part.col_ids, part.col_cnt,
                                      part.col_flag, part.diag_ids,
                                      part.diag_cnt, kv_map(h // 2, kh // 2),
                                      **kw)
            ref = vs_attention_reference(*args, part,
                                         kv_map(h // 2, kh // 2), **kw)
            full = vs_sparse_attention(flat(q), flat(k), flat(v), meta.col_ids,
                                       meta.col_cnt, meta.col_flag,
                                       meta.diag_ids, meta.diag_cnt,
                                       kv_map(h, kh), **kw)
        whole = full[mine]
    torch.cuda.synchronize()
    assert _row_rel_err(out, ref) <= 2.0**-6
    assert torch.equal(out, whole)


def test_tp_shaped_checkpoint_saved_on_card_loads_on_cpu(gen, tmp_path):
    """A tp=2 rank's cache shape (the toy engine's 2 KV heads of 4) saved
    from the card: loaded on the CPU every field is bit-equal with its
    dtype, and the file's head slices (as each rank of a tp=2 mesh loads
    them) put back together give it again."""
    from shadowkv_tpu_torch.cache.shadow import ShadowCache
    from shadowkv_tpu_torch.parallel.mesh import RankMesh
    from shadowkv_tpu_torch.utils import checkpoint

    eng, ids = _toy_engine("shadow", use_pallas=True)
    eng.generate(ids, gen_len=3)
    path = str(tmp_path / "ctx.npz")
    eng.save_state(path)
    src = eng._cache
    got = checkpoint.load_shadow_state(path, "cpu")
    parts = []
    for t in range(2):
        mesh = RankMesh(dp=1, tp=2, sp=1, pp=1,
                        coords={"dp": 0, "sp": 0, "tp": t, "pp": 0},
                        groups={}, group_ranks={}, batch_group=None,
                        batch_ranks=[0], backend="gloo")
        parts.append(checkpoint.load_shadow_state(path, "cpu", mesh=mesh))
    for name in ShadowCache.FIELDS + ("gen_len",):
        a = getattr(src, name)
        if a is None:
            assert getattr(got, name) is None, name
            continue
        b = getattr(got, name)
        assert b.device.type == "cpu" and b.dtype == a.dtype, name
        assert torch.equal(b, a.cpu()), name
        if name in checkpoint.HEAD_FIELDS:
            joined = torch.cat([getattr(p, name) for p in parts], dim=2)
        else:
            joined = getattr(parts[1], name)
        assert torch.equal(joined, b), name


def test_training_step_card_equals_cpu(gen):
    """The tiny trainer (``tools/train_tiny_model.py``) at a 2-layer f32
    config, ctx 96 at query chunks of 32, from the same weights on the card
    and on the CPU: step 0's loss within 1e-5 relative and each leaf's
    gradient within 1e-4 relative RMS (with TF32 products the largest leaf
    reads 1.9e-3 off, ``chip_smoke.check_train_step_parity``'s control);
    after two AdamW steps (the first at learning rate 0) each leaf's
    change within 1e-3 relative RMS of the CPU's (Adam's first update is
    ~sign(g), so an element with a near-zero gradient may flip)."""
    import numpy as np

    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config
    from shadowkv_tpu_torch.tools import train_tiny_model as tt

    cfg = toy_config(dtype=torch.float32)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 96))
    mask = rng.choice([0, 1, 1, 1, 2], (2, 96))
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_synthetic_params(cfg, torch.Generator().manual_seed(0),
                                       scale=0.1, device="cpu").to(dev)
        before = [t.detach().cpu().clone() for _, t in tt.named_leaves(params)]
        tr = tt.tiny_trainer(cfg, params, 1e-3, 10, 96, chunk=32)
        loss, _, _, grads = tr.grads(ids, mask)
        tr.opt.step(grads)
        tr.step(ids, mask)
        moved = [t.detach().cpu() - b
                 for (_, t), b in zip(tt.named_leaves(params), before)]
        out[dev] = (float(loss), [g.cpu() for g in grads], moved)

    def rel_rms(a, b):
        return float((a - b).norm() / b.norm())

    (l_c, g_c, m_c), (l_d, g_d, m_d) = out["cpu"], out["cuda"]
    assert abs(l_d - l_c) <= 1e-5 * abs(l_c)
    for a, b in zip(g_d, g_c):
        assert rel_rms(a, b) <= 1e-4
    for a, b in zip(m_d, m_c):
        assert b.norm() > 0 and rel_rms(a, b) <= 1e-3


def test_hybrid_engine_graph_steps_equal_eager_steps(gen):
    """K-EXAONE's hybrid step on a toy bf16 engine at head_dim 128 (kernel
    A's no-RoPE branch on the NoPE global layers, kernel C at window 128
    and the rings on the sliding ones, B, the decode-attention kernel, the
    masked expert pass): GRAPH_STEPS steps through the compiled step give
    the eager steps' tokens and bit-equal cache state, rings and expert
    choices included. The prefill's last-token logits lie within 5 % of
    the logits' spread of the float32 plain reference that follows the
    card's expert choices (bf16 activations over 9 post-norm layers read
    ~1 %), and those choices are the reference's top experts up to
    near-ties."""
    import dataclasses

    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.layers import ModelParams
    from shadowkv_tpu_torch.models.engine import Engine
    import reference_k_exaone as ref
    from test_torch_k_exaone import draw, ref_md, share, toy_model

    md32 = toy_model(head_dim=128, hidden_size=256, sliding_window=128)
    w = share(draw(md32, 0), md32.held)
    md = dataclasses.replace(md32, dtype=torch.bfloat16)
    keep = ("router", "e_bias")
    wb = {k: v if not torch.is_tensor(v) else
          (v if k in keep else v.bfloat16()).cuda() for k, v in w.items()}
    cc = CacheConfig(mode="shadow", max_length=512, sparse_budget=128,
                     rank=64, chunk_size=8, outlier_chunks=4, gen_capacity=32)
    eng = Engine(md, cc, RuntimeConfig(use_pallas=True),
                 ModelParams.from_tensors(wb, md), device="cuda")
    ids = np.random.RandomState(0).randint(1, md.vocab_size, (2, 512))
    eng.record_routes([0])
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    hy = cache.hybrid
    names = ("k_buf", "v_buf", "cached_ids", "gen_len")
    copy = dataclasses.replace(
        cache, **{n: getattr(cache, n).clone() for n in names},
        hybrid=dataclasses.replace(hy, ring_k=hy.ring_k.clone(),
                                   ring_v=hy.ring_v.clone(),
                                   route_ids=hy.route_ids.clone()))
    eager, t = [], tok
    for _ in range(GRAPH_STEPS):
        t = eng._decode(copy, t[:, None])[:, -1].argmax(-1).int()
        eager.append(t)
    zeros = torch.zeros(GRAPH_STEPS, 2, dtype=torch.int32, device="cuda")
    _, toks = eng.decode_chunk(cache, tok, zeros, zeros.bool())
    assert torch.equal(toks, torch.stack(eager).cpu())
    for n in names:
        assert torch.equal(getattr(cache, n), getattr(copy, n)), n
    for n in ("ring_k", "ring_v", "route_ids"):
        assert torch.equal(getattr(hy, n), getattr(copy.hybrid, n)), n
    assert len(eng._steps._graphs) == 1

    routes = {m: hy.prefill_routes[m, 0].cpu()
              for m in range(hy.prefill_routes.shape[0])}
    w_card = {k: v.float().cpu() if torch.is_tensor(v) else v
              for k, v in wb.items()}  # the card's (rounded) weights
    want, info = ref.forward(ref_md(md32), w_card, torch.as_tensor(ids[0]),
                             routes=routes)
    err = float((logits[0, -1].float().cpu() - want[-1]).abs().max()
                / want[-1].std())
    assert err < 0.05, err
    for m, chosen in routes.items():
        assert ref.route_regret(info["scores"][m], w["e_bias"][m],
                                chosen) < 0.05

"""MInference-style dynamic sparse prefill (counterpart of
``shadowkv_tpu/core/minference.py``).

Per-head patterns ``vertical_and_slash``, ``stream_llm``, ``block_sparse``
and ``dense``:

- Estimation: the last 64 queries attend all keys; the softmax's column
  sums score vertical token columns and its diagonal sums score slash
  diagonals; a top-k of each picks the pattern (the first 30 verticals and
  the nearest 100 slashes are forced).
- Block form: ``active[qb, kb] = causal & (col_flag[kb] | diag_flag[qb-kb])``,
  two 1-D flag sets per head (``VSMeta``), which the walk kernel G
  (``kernels/vs_sparse.py``) executes.
- Token form: verticals stay token-granular and slashes 128-wide bands,
  ``active(q, k) = causal & (diag_flag[(q-k)//block] | k in v_idx)``, which
  the tile kernel F (``kernels/vs_tile.py``) executes.

``stream_llm`` (sink + window) and ``dense`` are special cases of both
forms, so mixed per-head tables run in one kernel launch per layer;
``block_sparse`` heads run plain tensor code (as in the JAX package, where
they are plain XLA).

The JAX package also has ``minference_prefill_dynamic(_tile)`` for
per-layer tables, because its layer loop is a traced scan. The port's layer
loop is Python, so a per-layer table calls the static functions with that
layer's row (``patterns_to_arrays`` still validates the table).

Ties: ``jax.lax.top_k`` keeps the lower index among equal values; the port
takes a stable descending sort cut to k (``top_k``), which does the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

LAST_Q = 64
_NEG = torch.finfo(torch.float32).min
KINDS = ("vertical_and_slash", "stream_llm", "block_sparse", "dense")


@dataclasses.dataclass(frozen=True)
class HeadPattern:
    """Per-q-head sparse-prefill pattern."""

    kind: str = "vertical_and_slash"
    vertical_size: int = 1000
    slash_size: int = 6144


@dataclasses.dataclass
class VSMeta:
    """Active-block metadata for [BH] rows, block granular (int32):

    col_ids  [BH, nK] active column blocks ascending, padded with nK;
    col_cnt  [BH, nQ] active column blocks with kb <= qb;
    col_flag [BH, nK] 0/1 membership;
    diag_ids [BH, nQ] active diagonal offsets ascending, padded with nQ;
    diag_cnt [BH, nQ] active diagonals with delta <= qb.
    """

    col_ids: torch.Tensor
    col_cnt: torch.Tensor
    col_flag: torch.Tensor
    diag_ids: torch.Tensor
    diag_cnt: torch.Tensor


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order), int32."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def estimate_vertical_slash(
    q: torch.Tensor,  # [B, S, H, Dh] roped queries
    k: torch.Tensor,  # [B, S, K, Dh] roped keys
    scale: Optional[float] = None,
    last_q: int = LAST_Q,
    head_kv: Optional[Sequence[int]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vertical and slash scores [B, H, S] (f32) from the last ``last_q``
    queries: an f32 softmax of those queries against all keys (causal on
    the trailing square), summed over rows for verticals and along
    diagonals for slashes (slash index d scores distance d). The first 30
    verticals and the nearest 100 slashes are +inf. ``head_kv`` names the
    KV head of each q head (default h // G). Runs one KV head's query
    heads at a time, so the score temporaries stay [B, G, last_q, S]."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    lq = min(last_q, s)
    scale = scale if scale is not None else dh**-0.5
    kv_of = list(head_kv) if head_kv is not None else [i // g for i in range(h)]
    ii = torch.arange(lq, device=q.device)
    tail_mask = ii[:, None] >= ii[None, :]
    w = s + lq
    vertical = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    slash = torch.empty_like(vertical)
    for kv in sorted(set(kv_of)):
        heads = [i for i, x in enumerate(kv_of) if x == kv]
        q_t = q[:, -lq:, heads].float().transpose(1, 2)  # [B, G', lq, Dh]
        k_t = k[:, :, kv].float()  # [B, S, Dh]
        qk = torch.matmul(q_t, k_t[:, None].transpose(-1, -2)) * scale
        qk[..., s - lq:] = torch.where(tail_mask, qk[..., s - lq:], _NEG)
        p = torch.softmax(qk, dim=-1)  # [B, G', lq, S]
        vertical[:, heads] = p.sum(dim=2)
        # slash[d] = sum_i p[i, s-lq+i-d]: reverse each row, right-pad by
        # lq, and view row i shifted by lq-1-i (row stride w-1), so the
        # diagonals become columns; out-of-range ones read the padding.
        pr = torch.nn.functional.pad(torch.flip(p, dims=(-1,)), (0, lq))
        pr = pr.reshape(-1, lq, w).contiguous()
        sheared = pr.as_strided((pr.shape[0], lq, s), (lq * w, w - 1, 1),
                                lq - 1)
        slash[:, heads] = sheared.sum(dim=1).reshape(b, len(heads), s)
    vertical[..., : min(30, s)] = torch.inf
    slash[..., : min(100, s)] = torch.inf
    return vertical, slash


def _compact_flags(flags: torch.Tensor, pad_value: int) -> torch.Tensor:
    """[..., N] 0/1 flags -> ids of set positions ascending, the rest
    ``pad_value`` at the tail."""
    iota = torch.arange(flags.shape[-1], dtype=torch.int32, device=flags.device)
    masked = torch.where(flags > 0, iota, torch.tensor(pad_value, dtype=torch.int32,
                                                       device=flags.device))
    return torch.sort(masked, dim=-1).values


def _scatter_flags(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[..., M] indices -> [..., N] 0/1 int32 flags (duplicates fold;
    indices outside [0, N) set nothing)."""
    idx = idx.long()
    tgt = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.zeros(idx.shape[:-1] + (n + 1,), dtype=torch.int32,
                      device=idx.device)
    return out.scatter_(-1, tgt, 1)[..., :n].contiguous()


def meta_from_flags(col_flag: torch.Tensor, diag_flag: torch.Tensor) -> VSMeta:
    """Kernel metadata (sorted id lists + causal prefix counts) from 0/1
    activity flags."""
    n_blk = col_flag.shape[-1]
    col_flag = col_flag.to(torch.int32)
    diag_flag = diag_flag.to(torch.int32)
    return VSMeta(
        col_ids=_compact_flags(col_flag, n_blk),
        col_cnt=torch.cumsum(col_flag, dim=-1).to(torch.int32),
        col_flag=col_flag,
        diag_ids=_compact_flags(diag_flag, n_blk),
        diag_cnt=torch.cumsum(diag_flag, dim=-1).to(torch.int32),
    )


def diag_flags_from_slash(s_idx: torch.Tensor, n_blk: int, block: int):
    """Block-diagonal flags from token slash distances: distance d crosses
    block diagonals floor(d/B) and ceil(d/B); the main block diagonal (the
    causal frontier) is always on."""
    d1 = s_idx // block
    d2 = (s_idx + block - 1) // block
    flags = _scatter_flags(torch.cat([d1, d2], dim=-1), n_blk)
    flags[..., 0] = 1
    return flags


def vs_flags(v_idx: torch.Tensor, s_idx: torch.Tensor, n_blk: int, block: int):
    """(col_flag, diag_flag) from token selections; entries >= n_blk*block
    are padding."""
    return (_scatter_flags(v_idx // block, n_blk),
            diag_flags_from_slash(s_idx, n_blk, block))


def build_vs_meta(v_idx: torch.Tensor, s_idx: torch.Tensor, seq_len: int,
                  block: int) -> VSMeta:
    """Block metadata from token-granular verticals/slashes."""
    n_blk = (seq_len + block - 1) // block
    return meta_from_flags(*vs_flags(v_idx, s_idx, n_blk, block))


def stream_flags(bh: int, seq_len: int, block: int, sink: int, window: int,
                 device=None):
    """stream_llm as block flags: columns = the sink blocks, diagonals =
    the window's block diagonals."""
    n_blk = (seq_len + block - 1) // block
    kb = torch.arange(n_blk, dtype=torch.int32, device=device)
    col = (kb * block < sink).to(torch.int32).expand(bh, n_blk).contiguous()
    diag = (kb * block < window + block).to(torch.int32).expand(bh, n_blk)
    return col, diag.contiguous()


def stream_meta(bh: int, seq_len: int, block: int, sink: int, window: int,
                device=None) -> VSMeta:
    """The stream_llm pattern as VS block metadata."""
    return meta_from_flags(*stream_flags(bh, seq_len, block, sink, window,
                                         device))


def topk_sizes(vertical_size: int, slash_size: int, seq_len: int):
    """Top-k sizes after the reference's clamps (vertical >= 30, slash >=
    50, both <= seq_len)."""
    return (min(seq_len, max(vertical_size, 30)),
            min(seq_len, max(slash_size, 50)))


def vs_meta_from_scores(
    vertical: torch.Tensor,  # [BH, S]
    slash: torch.Tensor,  # [BH, S]
    vertical_size: int,
    slash_size: int,
    seq_len: int,
    block: int,
    grid_len: Optional[int] = None,
) -> VSMeta:
    """Top-k the scores and build block metadata over ``grid_len``
    (default ``seq_len``) positions."""
    vsize, ssize = topk_sizes(vertical_size, slash_size, seq_len)
    return build_vs_meta(top_k(vertical, vsize), top_k(slash, ssize),
                         grid_len or seq_len, block)


def expand_block_mask(meta: VSMeta, n_blk: int) -> torch.Tensor:
    """[BH, nQ, nK] boolean active-block mask from metadata."""
    dev = meta.col_flag.device
    qb = torch.arange(n_blk, device=dev)[:, None]
    kb = torch.arange(n_blk, device=dev)[None, :]
    diag = _scatter_flags(meta.diag_ids, n_blk) > 0  # [BH, n]
    delta = (qb - kb).clamp(0, n_blk - 1)
    return (kb <= qb)[None] & ((meta.col_flag[:, None, :] > 0)
                               | diag[:, delta])


def masked_attention(q, k_g, v_g, mask, scale):
    """softmax(q k^T * scale | mask) v for q [BH, n, Dh] against k_g/v_g
    [BH, T, Dh] (f32 scores; probabilities in v's dtype, as JAX)."""
    scores = torch.matmul(q.float(), k_g.transpose(1, 2)) * scale
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v_g.dtype)
    return torch.matmul(probs.float(), v_g.float())


def vs_attention_reference(
    q: torch.Tensor,  # [BH, S, Dh]
    k: torch.Tensor,  # [BKV, S, Dh]
    v: torch.Tensor,  # [BKV, S, Dh]
    meta: VSMeta,
    kv_map: torch.Tensor,  # [BH] q row -> kv row
    block: int,
    scale: Optional[float] = None,
    seq_len: Optional[int] = None,
    block_q: int = 256,
) -> torch.Tensor:
    """Plain version of kernel G: token mask = expanded block mask AND
    causal AND k < seq_len, blockwise over ``block_q`` queries (the JAX
    oracle holds [BH, S, S]). Returns [BH, S, Dh] in q's dtype; rows past
    ``seq_len`` are garbage."""
    bh, s, dh = q.shape
    seq_len = s if seq_len is None else seq_len
    scale = scale if scale is not None else dh**-0.5
    kv_map = kv_map.long()
    k_g, v_g = k.float()[kv_map], v[kv_map]
    outs = [masked_attention(q[:, q0:q0 + block_q], k_g, v_g, mask, scale)
            for q0, mask in walk_masks(meta, block, s, seq_len, block_q)]
    return torch.cat(outs, dim=1).to(q.dtype)


def walk_masks(meta: VSMeta, block: int, s: int, seq_len: int, block_q: int):
    """(q0, token mask [BH, block_q, S]) over the query blocks of kernel G's
    function: expanded block mask AND causal AND k < seq_len."""
    if s % block:
        raise ValueError(f"S {s} must be a multiple of block {block}")
    n_blk = s // block
    diag = _scatter_flags(meta.diag_ids, n_blk) > 0  # [BH, n]
    pos = torch.arange(s, device=meta.col_flag.device)
    kb = pos // block
    col = (meta.col_flag > 0)[:, kb]  # [BH, S]
    for q0 in range(0, s, block_q):
        pq = pos[q0:q0 + block_q]
        delta = (pq[:, None] // block - kb[None, :]).clamp(0, n_blk - 1)
        yield q0, ((pos[None, :] <= pq[:, None])
                   & (pos[None, :] < seq_len))[None] \
            & (col[:, None, :] | diag[:, delta])


def active_pairs(masks, seq_len: int) -> int:
    """Active (query, key) pairs of the rows below ``seq_len`` over the
    (q0, mask) blocks of ``walk_masks`` or ``vs_tile.tile_masks``: the work
    the kernels' bounds count."""
    return sum(int(m[:, :max(0, seq_len - q0)].sum()) for q0, m in masks)


def block_sparse_attention(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, K, Dh]
    v: torch.Tensor,  # [B, S, K, Dh]
    topk_blocks: int = 100,
    block: int = 64,
    scale: Optional[float] = None,
    head_kv: Optional[Sequence[int]] = None,
    block_q: int = 256,
) -> torch.Tensor:
    """Block-granular top-k sparse attention (MInference
    ``block_sparse_attention``): q and k are mean-pooled into ``block``-token
    blocks, each query block attends its top-k key blocks (its own block
    always included), with token causality. Plain tensor code: the selected
    blocks become a block mask over a dense masked softmax, blockwise over
    queries. Returns [B, S, H, Dh]."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kv_of = list(head_kv) if head_kv is not None else [i // g for i in range(h)]
    scale = scale if scale is not None else dh**-0.5
    s_real = s
    if s % block:
        # Zero-pad to a block multiple: padded keys are causally masked for
        # every real row; padded rows are sliced off.
        pad = block - s % block
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        s += pad
    nb = s // block
    tk = min(topk_blocks, nb)
    q_blk = q.reshape(b, nb, block, h, dh).mean(dim=2)  # [B, nb, H, Dh]
    k_blk = k.reshape(b, nb, block, -1, dh).mean(dim=2)
    ids = torch.arange(nb, device=q.device)
    pos = torch.arange(s, device=q.device)
    out = torch.empty(b, s, h, dh, dtype=q.dtype, device=q.device)
    for hh, kv in enumerate(kv_of):
        scores = torch.matmul(q_blk[:, :, hh].float(),
                              k_blk[:, :, kv].float().transpose(1, 2))
        scores = torch.where(ids[None, :] <= ids[:, None], scores, _NEG)
        scores = torch.where(ids[None, :] == ids[:, None], torch.inf, scores)
        sel = top_k(scores, tk).long()  # [B, nb, tk]
        blk = torch.zeros(b, nb, nb, dtype=torch.bool, device=q.device)
        blk.scatter_(-1, sel, True)
        k_h, v_h = k[:, :, kv].float(), v[:, :, kv]
        for q0 in range(0, s, block_q):
            pq = pos[q0:q0 + block_q]
            mask = blk[:, pq // block][:, :, pos // block] \
                & (pos[None, :] <= pq[:, None])[None]
            out[:, q0:q0 + block_q, hh] = masked_attention(
                q[:, q0:q0 + block_q, hh], k_h, v_h, mask, scale).to(q.dtype)
    return out[:, :s_real]


def resolve_patterns(patterns: Optional[Sequence], num_heads: int,
                     vertical_size: int, slash_size: int) -> tuple:
    """Normalize a per-head spec (HeadPattern, (kind, vsize, ssize) tuples
    or bare kind strings) to ``num_heads`` (kind, vsize, ssize) tuples."""
    if patterns is None:
        return tuple(("vertical_and_slash", vertical_size, slash_size)
                     for _ in range(num_heads))
    if len(patterns) != num_heads:
        raise ValueError(f"pattern table has {len(patterns)} heads, the "
                         f"model {num_heads}")
    out = []
    for p in patterns:
        if isinstance(p, HeadPattern):
            out.append((p.kind, p.vertical_size, p.slash_size))
        elif isinstance(p, str):
            out.append((p, vertical_size, slash_size))
        else:
            out.append((p[0], p[1], p[2]))
    for kind, *_ in out:
        if kind not in KINDS:
            raise ValueError(f"unknown head pattern kind {kind!r}")
    return tuple(out)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def flat_heads(t: torch.Tensor, s_pad: int) -> torch.Tensor:
    """[B, S, N, Dh] -> [B*N, S_pad, Dh] (zero rows past S), contiguous as
    the kernels read it (at B 1 the reshape alone would give a strided
    view)."""
    b, s, n, dh = t.shape
    return _pad_seq(t, s_pad - s).transpose(1, 2).reshape(
        b * n, s_pad, dh).contiguous()


def _estimate(q, k, pats, scale, meta_heads, g):
    """Scores of the vertical_and_slash heads among ``meta_heads``:
    ({head: row}, vertical, slash) with [B, Hv, S] scores."""
    vs_heads = [i for i in meta_heads if pats[i][0] == "vertical_and_slash"]
    if not vs_heads:
        return {}, None, None
    vertical, slash = estimate_vertical_slash(
        q[:, :, vs_heads], k, scale, head_kv=[i // g for i in vs_heads])
    return {hh: j for j, hh in enumerate(vs_heads)}, vertical, slash


def kv_map_of(b: int, kh: int, heads: Sequence[int], g: int, device):
    rows = torch.tensor([hh // g for hh in heads], dtype=torch.int32,
                        device=device)
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None] * kh
            + rows[None, :]).reshape(-1)


def _head_groups(pats, meta_heads, rows, vertical, slash, s: int):
    """The non-block_sparse heads grouped by (kind, sizes): yields (kind,
    js, v_top, s_top) with ``js`` the heads' positions in ``meta_heads``
    and, for vertical_and_slash, one vectorized top-k per group ([B, hg, k]
    vertical token ids and slash distances; None for the other kinds)."""
    groups: dict = {}
    for j, i in enumerate(meta_heads):
        groups.setdefault(pats[i], []).append(j)
    for (kind, vsize, ssize), js in groups.items():
        v_top = s_top = None
        if kind == "vertical_and_slash":
            r = [rows[meta_heads[j]] for j in js]
            vsz, ssz = topk_sizes(vsize, ssize, s)
            v_top, s_top = top_k(vertical[:, r], vsz), top_k(slash[:, r], ssz)
        yield kind, js, v_top, s_top


def _with_block_sparse(out, q, k, v, pats, g, bs_topk_blocks, bs_block, scale):
    bs_heads = [i for i, p in enumerate(pats) if p[0] == "block_sparse"]
    if bs_heads:
        out[:, :, bs_heads] = block_sparse_attention(
            q[:, :, bs_heads], k, v, topk_blocks=bs_topk_blocks,
            block=bs_block, scale=scale, head_kv=[hh // g for hh in bs_heads],
        ).to(q.dtype)
    return out


def minference_prefill(
    q: torch.Tensor,  # [B, S, H, Dh] roped queries
    k: torch.Tensor,  # [B, S, K, Dh] roped keys
    v: torch.Tensor,  # [B, S, K, Dh]
    *,
    patterns: Optional[Sequence] = None,
    vertical_size: int = 1000,
    slash_size: int = 6144,
    block: int = 128,
    stream_sink: int = 1024,
    stream_window: int = 8192,
    bs_topk_blocks: int = 100,
    bs_block: int = 64,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-head sparse prefill through the block walk (``vs_impl="walk"``):
    vertical_and_slash, stream_llm and dense heads become VS block
    metadata and run in ONE launch of kernel G (``kernels/vs_sparse.py``;
    its plain version on CPU tensors); block_sparse heads run
    ``block_sparse_attention``. Returns [B, S, H, Dh]."""
    from shadowkv_tpu_torch.kernels.vs_sparse import vs_sparse_attention

    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else dh**-0.5
    pats = resolve_patterns(patterns, h, vertical_size, slash_size)
    meta_heads = [i for i, p in enumerate(pats) if p[0] != "block_sparse"]
    s_pad = _round_up(s, block)
    n_blk = s_pad // block
    out = torch.zeros_like(q)
    if meta_heads:
        rows, vertical, slash = _estimate(q, k, pats, scale, meta_heads, g)
        col = torch.empty(b, len(meta_heads), n_blk, dtype=torch.int32,
                          device=q.device)
        diag = torch.empty_like(col)
        for kind, js, v_top, s_top in _head_groups(pats, meta_heads, rows,
                                                   vertical, slash, s):
            hg = len(js)
            if kind == "vertical_and_slash":
                c, d = vs_flags(v_top, s_top, n_blk, block)
            elif kind == "stream_llm":
                c, d = stream_flags(b * hg, s_pad, block, stream_sink,
                                    stream_window, q.device)
            else:  # dense: every diagonal active == full causal
                c, d = stream_flags(b * hg, s_pad, block, 0, s_pad * block,
                                    q.device)
            col[:, js] = c.reshape(b, hg, n_blk)
            diag[:, js] = d.reshape(b, hg, n_blk)
        meta = meta_from_flags(col.reshape(-1, n_blk), diag.reshape(-1, n_blk))
        o_f = vs_sparse_attention(
            flat_heads(q[:, :, meta_heads], s_pad), flat_heads(k, s_pad),
            flat_heads(v, s_pad), meta.col_ids, meta.col_cnt, meta.col_flag,
            meta.diag_ids, meta.diag_cnt,
            kv_map_of(b, kh, meta_heads, g, q.device),
            block=block, scale=scale, seq_len=s,
        )
        out[:, :, meta_heads] = o_f.reshape(b, len(meta_heads), s_pad, dh)[
            :, :, :s].transpose(1, 2).to(q.dtype)
    return _with_block_sparse(out, q, k, v, pats, g, bs_topk_blocks, bs_block,
                              scale)


def minference_prefill_tile(
    q: torch.Tensor,  # [B, S, H, Dh] roped queries
    k: torch.Tensor,  # [B, S, K, Dh] roped keys
    v: torch.Tensor,  # [B, S, K, Dh]
    *,
    patterns: Optional[Sequence] = None,
    vertical_size: int = 1000,
    slash_size: int = 6144,
    block: int = 128,
    stream_sink: int = 1024,
    stream_window: int = 8192,
    bs_topk_blocks: int = 100,
    bs_block: int = 64,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-head sparse prefill through the tile kernel (``vs_impl="tile"``,
    the default): verticals token-granular, slashes as block bands, one
    launch of kernel F (``kernels/vs_tile.py``) for every non-block_sparse
    head:

      vertical_and_slash: v_idx = top-k vertical tokens, diag = the bands
                          of the top-k slashes
      stream_llm:         v_idx = the sink tokens, diag = the window's bands
      dense:              diag = every band

    S is padded to a multiple of ``block`` and of kernel F's 128-row tile
    (JAX's ``tile`` argument sizes the TPU kernel's tiles only; padded rows
    are sliced off and padded keys masked, so it changes no result);
    vertical lists are padded to one capacity with ``2 * S_pad``. Returns
    [B, S, H, Dh]."""
    from shadowkv_tpu_torch.kernels.vs_tile import TILE, vs_tile_attention

    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else dh**-0.5
    pats = resolve_patterns(patterns, h, vertical_size, slash_size)
    meta_heads = [i for i, p in enumerate(pats) if p[0] != "block_sparse"]
    s_pad = _round_up(s, max(block, TILE))
    n_blk = s_pad // block
    out = torch.zeros_like(q)
    if meta_heads:
        rows, vertical, slash = _estimate(q, k, pats, scale, meta_heads, g)
        nv_cap = max(topk_sizes(vsize, 0, s)[0] if kind == "vertical_and_slash"
                     else min(stream_sink, s) if kind == "stream_llm" else 1
                     for kind, vsize, _ in (pats[i] for i in meta_heads))
        pad_tok = 2 * s_pad
        v_all = torch.full((b, len(meta_heads), nv_cap), pad_tok,
                           dtype=torch.int32, device=q.device)
        d_all = torch.ones(b, len(meta_heads), n_blk, dtype=torch.int32,
                           device=q.device)  # dense: every band
        kb = torch.arange(n_blk, dtype=torch.int32, device=q.device)
        for kind, js, v_top, s_top in _head_groups(pats, meta_heads, rows,
                                                   vertical, slash, s):
            if kind == "vertical_and_slash":
                v_all[:, js, :v_top.shape[-1]] = v_top
                d_all[:, js] = diag_flags_from_slash(s_top, n_blk, block)
            elif kind == "stream_llm":
                n_sink = min(stream_sink, s)
                v_all[:, js, :n_sink] = torch.arange(
                    n_sink, dtype=torch.int32, device=q.device)
                d_all[:, js] = (kb * block < stream_window + block).to(
                    torch.int32)
        o_f = vs_tile_attention(
            flat_heads(q[:, :, meta_heads], s_pad), flat_heads(k, s_pad),
            flat_heads(v, s_pad), v_all.reshape(-1, nv_cap),
            d_all.reshape(-1, n_blk),
            kv_map_of(b, kh, meta_heads, g, q.device),
            block=block, scale=scale, seq_len=s,
        )
        out[:, :, meta_heads] = o_f.reshape(b, len(meta_heads), s_pad, dh)[
            :, :, :s].transpose(1, 2).to(q.dtype)
    return _with_block_sparse(out, q, k, v, pats, g, bs_topk_blocks, bs_block,
                              scale)


KIND_IDS = {"vertical_and_slash": 0, "stream_llm": 1, "dense": 2}


def patterns_to_arrays(
    layer_patterns: Sequence,  # [L] per-head tables
    num_heads: int,
    num_layers: int,
    vertical_size: int,
    slash_size: int,
):
    """A per-layer table as numpy arrays (kind_ids [L, H], vertical [L, H],
    slash [L, H]) plus the top-k caps (max sizes over the table, at least
    30 and 50). ``block_sparse`` is not allowed in per-layer tables (as in
    the JAX package, whose per-layer path has one metadata form)."""
    if len(layer_patterns) != num_layers:
        raise ValueError(f"per-layer table has {len(layer_patterns)} layers, "
                         f"the model {num_layers}")
    kinds = np.zeros((num_layers, num_heads), np.int32)
    vs = np.zeros((num_layers, num_heads), np.int32)
    ss = np.zeros((num_layers, num_heads), np.int32)
    for li, table in enumerate(layer_patterns):
        pats = resolve_patterns(table, num_heads, vertical_size, slash_size)
        for hh, (kind, vsize, ssize) in enumerate(pats):
            if kind == "block_sparse":
                raise ValueError(
                    "per-layer pattern tables do not support block_sparse "
                    f"(layer {li}, head {hh})"
                )
            kinds[li, hh] = KIND_IDS[kind]
            vs[li, hh] = vsize
            ss[li, hh] = ssize
    vs_heads = kinds == 0
    v_cap = int(vs[vs_heads].max()) if vs_heads.any() else 30
    s_cap = int(ss[vs_heads].max()) if vs_heads.any() else 50
    return kinds, vs, ss, max(v_cap, 30), max(s_cap, 50)

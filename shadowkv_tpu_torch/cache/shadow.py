"""ShadowKV sparse KV cache (counterpart of ``shadowkv_tpu/cache/shadow.py``).

Low-rank pre-RoPE K factors and a chunked V store, landmark-selected
sparse attention over a compact buffer, slot-stable hit reuse, and the two
decode strategies of the JAX package: the fused refresh of missed chunks
(``kernels/reconstruct.py``) and the XLA-gather branch, which gathers every
selected chunk (by tensor indexing, or by the chunk-gather kernel of
``kernels/gather.py`` with ``ring=True``) and keeps hit slots by a select.

The V store may live in host memory (``mode="shadow_offload"``): a pinned
CPU tensor when the engine runs on the card, which both decode kernels
read in place, and from which the XLA-gather branch without a kernel
reads the missed chunks only (``kernels/gather.py::gather_v_rows``, JAX's
``HostVStore`` path); every other field stays on the engine's device.

Compact buffer per (layer, batch, kv head), as in the JAX package:

    [ prefill_local | outlier_chunks * chunk | sparse_budget | gen ]
      0 .. pl         pl .. sparse_start       .. sparse_end    .. cap

State lives in stacked [L, B, ...] tensors that prefill and decode update
IN PLACE (JAX threads new buffers through ``dynamic_update_slice`` and
donation). ``gen_len`` is an int32 tensor on the cache's device, as JAX's
is, advanced in place: a decode step reads it only on the device (the RoPE
rows, the gen row it writes, the forced ids), so a CUDA graph of the step
stays valid from one token to the next. It is 0-d, or [B] when every slot
sits at its own generation depth (continuous batching, ``serving.py``):
then the RoPE rows gain a batch dimension and each slot's new rows go to
its own gen row, by one scatter.

Store layout is the port's own (the TPU package pads the rank to 128
lanes, embeds int8 scales in U's tail lanes and tiles int8 chunks for
Mosaic's DMA rules):

    u        [L, B, C*cs, rank]      int8 | model dtype (shared by heads)
    u_scale  [L, B, C*cs]            bf16 (int8 stores only)
    v_full   [L, B, K, C*cs, Dh]     int8 | model dtype
    v_scale  [L, B, K, C*cs]         bf16 (int8 stores only)

Chunk c occupies store rows [c*cs, c*cs + cs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from shadowkv_tpu_torch.cache.hybrid import HybridState
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core.lowrank import lowrank_kv_factors
from shadowkv_tpu_torch.core.quant import quantize_rows, quantize_store
from shadowkv_tpu_torch.core.selection import (
    chunk_ids_to_positions,
    compact_misses,
    compute_landmarks_outliers,
    score_and_select,
)
from shadowkv_tpu_torch.kernels.gather import gather_chunks, gather_v_rows
from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
from shadowkv_tpu_torch.kernels.select import select_slots
from shadowkv_tpu_torch.utils import profiling as prof


@dataclasses.dataclass(frozen=True)
class ShadowLayout:
    """Static geometry of the shadow cache, from the prefill length: context
    chunks rounded down to a multiple of 8, the remainder plus the last
    ``local_chunks`` chunks kept dense as the local region."""

    prefill_len: int
    chunk_size: int
    chunks: int  # context chunks (landmark + outlier candidates)
    prefill_local: int  # dense local region (remainder + local chunks)
    outlier_chunks: int
    num_landmarks: int  # chunks - outlier_chunks
    select_sets: int  # sparse_budget // chunk_size
    sparse_start: int
    sparse_end: int
    gen_capacity: int
    buffer_cap: int
    rank: int
    quant: str = "none"  # 'none' | 'int8'

    @classmethod
    def build(cls, cache: CacheConfig, prefill_len: int) -> "ShadowLayout":
        cs = cache.chunk_size
        if prefill_len % 8:
            raise ValueError("prefill length must be 8-aligned")
        chunks = prefill_len // cs - cache.local_chunks
        chunks -= chunks % 8
        outl = cache.resolved_outlier_chunks()
        select_sets = cache.select_sets
        if select_sets + outl > chunks:
            raise ValueError(
                f"prefill {prefill_len} too short for sparse_budget "
                f"{cache.sparse_budget} + {outl} outliers"
            )
        prefill_local = prefill_len - chunks * cs
        sparse_start = prefill_local + outl * cs
        sparse_end = sparse_start + cache.sparse_budget
        return cls(
            prefill_len=prefill_len,
            chunk_size=cs,
            chunks=chunks,
            prefill_local=prefill_local,
            outlier_chunks=outl,
            num_landmarks=chunks - outl,
            select_sets=select_sets,
            sparse_start=sparse_start,
            sparse_end=sparse_end,
            gen_capacity=cache.gen_capacity,
            buffer_cap=sparse_end + cache.gen_capacity,
            rank=cache.rank,
            quant=cache.kv_quant,
        )


@dataclasses.dataclass
class ShadowCache:
    """Stacked-over-layers ShadowKV state, updated in place."""

    u: torch.Tensor
    sv: torch.Tensor  # [L, B, K, rank, Dh]
    landmarks: torch.Tensor  # [L, B, K, C, Dh] int8 | model dtype
    landmark_mask: torch.Tensor  # [L, B, K, C] bool, False at outliers
    k_buf: torch.Tensor  # [L, B, K, cap, Dh] compact post-RoPE K
    v_buf: torch.Tensor  # [L, B, K, cap, Dh]
    v_full: torch.Tensor
    cached_ids: torch.Tensor  # [L, B, K, S] int32 chunk ids in sparse slots
    layout: ShadowLayout
    gen_len: torch.Tensor | int = 0  # tokens in the gen region (int32, 0-d | [B])
    lm_scale: Optional[torch.Tensor] = None  # [L, B, K, C] f32 (int8)
    u_scale: Optional[torch.Tensor] = None  # [L, B, C*cs] bf16 (int8)
    v_scale: Optional[torch.Tensor] = None  # [L, B, K, C*cs] bf16 (int8)
    v_on_host: bool = False  # v_full lives in host memory (offload)
    # A hybrid model's sliding-layer rings and expert choices
    # (cache/hybrid.py); the fields above then hold its full-attention
    # layers only, in order.
    hybrid: Optional[HybridState] = None

    FIELDS = ("u", "sv", "landmarks", "landmark_mask", "k_buf", "v_buf",
              "v_full", "cached_ids", "lm_scale", "u_scale", "v_scale")

    def __post_init__(self):
        if not isinstance(self.gen_len, torch.Tensor):
            self.gen_len = torch.tensor(self.gen_len, dtype=torch.int32,
                                        device=self.k_buf.device)

    @property
    def kv_len(self) -> torch.Tensor:
        """Logical KV length (prefill + generated), a device tensor shaped
        as ``gen_len``."""
        return self.layout.prefill_len + self.gen_len

    @classmethod
    def init(
        cls, model: ModelConfig, layout: ShadowLayout, batch_size: int,
        device=None, v_on_host: bool = False,
    ) -> "ShadowCache":
        """Zeroed full-batch buffers; sub-batch prefill writes slices.

        With ``v_on_host`` the V store is one uninitialised CPU tensor,
        pinned when ``device`` is a CUDA device (prefill writes every row
        of it)."""
        l, b = len(model.global_layers), batch_size
        kh, dh, dt = model.num_kv_heads, model.head_dim, model.dtype
        lo = layout
        cs = lo.chunk_size
        q8 = lo.quant == "int8"
        if q8 and 32 % cs:
            raise ValueError(
                f"kv_quant='int8' needs chunk_size dividing 32, got {cs}"
            )
        store_dt = torch.int8 if q8 else dt
        rows = lo.chunks * cs

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            u=z((l, b, rows, lo.rank), store_dt),
            sv=z((l, b, kh, lo.rank, dh), dt),
            landmarks=z((l, b, kh, lo.chunks, dh), store_dt),
            landmark_mask=z((l, b, kh, lo.chunks), torch.bool),
            k_buf=z((l, b, kh, lo.buffer_cap, dh), dt),
            v_buf=z((l, b, kh, lo.buffer_cap, dh), dt),
            v_full=torch.empty(
                (l, b, kh, rows, dh), dtype=store_dt,
                pin_memory=torch.device(device or "cpu").type == "cuda",
            ) if v_on_host else z((l, b, kh, rows, dh), store_dt),
            cached_ids=z((l, b, kh, lo.select_sets), torch.int32),
            layout=layout,
            lm_scale=z((l, b, kh, lo.chunks), torch.float32) if q8 else None,
            u_scale=z((l, b, rows), torch.bfloat16) if q8 else None,
            v_scale=z((l, b, kh, rows), torch.bfloat16) if q8 else None,
            v_on_host=v_on_host,
        )


def shadow_prefill_layer(
    model: ModelConfig,
    layout: ShadowLayout,
    k_pre_rope: torch.Tensor,  # [B, S, K, Dh]
    k_roped: torch.Tensor,  # [B, S, K, Dh]
    v: torch.Tensor,  # [B, S, K, Dh]
    q_last: torch.Tensor,  # [B, 1, H, Dh] last prefill query (roped)
    omega: torch.Tensor | None = None,  # low-rank sketch (core/lowrank.py)
    tp=None,  # tensor-parallel group: k/v/q hold this rank's heads
) -> dict:
    """One layer's shadow-cache slices at prefill: low-rank factors of
    pre-RoPE K, landmarks/outliers of post-RoPE K, int8 stores, and the
    compact buffer seeded with the EXACT post-RoPE K/V of the last prefill
    query's selection (not a reconstruction).

    Under tp only the factorization talks to the other ranks (its sums run
    over ``tp``); landmarks, outliers, the seed selection and every store
    are per KV head, and the int8 scales of V and of the landmarks sit per
    head in their own tensors, so they stay local and need no head offset
    (JAX passes ``head_offset`` to its refresh because its scales are packed
    per global head in U's tail lanes)."""
    b, s, kh, dh = v.shape
    lo = layout
    cs = lo.chunk_size
    ctx = lo.chunks * cs

    u, sv = lowrank_kv_factors(
        k_pre_rope.reshape(b, s, kh * dh), lo.rank, kh, dh,
        dtype=model.dtype, omega=omega, tp=tp,
    )
    u = u[:, :ctx]  # decode only reconstructs context chunks

    k_roped_h = k_roped.transpose(1, 2)  # [B, K, S, Dh]
    v_h = v.transpose(1, 2)
    k_ctx = k_roped_h[:, :, :ctx].reshape(b, kh, lo.chunks, cs, dh)
    v_ctx = v_h[:, :, :ctx]
    lm = compute_landmarks_outliers(k_ctx, lo.outlier_chunks)

    k_buf = torch.zeros(b, kh, lo.buffer_cap, dh, dtype=model.dtype,
                        device=v.device)
    v_buf = torch.zeros_like(k_buf)
    pl = lo.prefill_local
    k_buf[:, :, :pl] = k_roped_h[:, :, s - pl:]
    v_buf[:, :, :pl] = v_h[:, :, s - pl:]
    out_pos = chunk_ids_to_positions(lm.outlier_idx, cs)  # [B, K, O*cs]
    k_buf[:, :, pl:lo.sparse_start] = _rows(k_roped_h, out_pos)
    v_buf[:, :, pl:lo.sparse_start] = _rows(v_h, out_pos)

    q_grouped = q_last.transpose(1, 2).reshape(b, kh, model.num_groups, 1, dh)
    seed_ids = score_and_select(
        q_grouped, lm.landmarks, lm.landmark_mask, lo.select_sets
    )
    seed_pos = chunk_ids_to_positions(seed_ids, cs)
    k_buf[:, :, lo.sparse_start:lo.sparse_end] = _rows(k_roped_h, seed_pos)
    v_buf[:, :, lo.sparse_start:lo.sparse_end] = _rows(v_h, seed_pos)

    out = dict(
        sv=sv, landmark_mask=lm.landmark_mask, k_buf=k_buf, v_buf=v_buf,
        cached_ids=seed_ids,
    )
    if lo.quant == "int8":
        out["u"], out["u_scale"] = quantize_store(u)
        out["v_full"], out["v_scale"] = quantize_store(v_ctx)
        out["landmarks"], out["lm_scale"] = quantize_rows(lm.landmarks)
    else:
        out.update(u=u, v_full=v_ctx, landmarks=lm.landmarks)
    return out


def _rows(x_h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x_h [B, K, S, Dh] rows at pos [B, K, N] -> [B, K, N, Dh]."""
    idx = pos[..., None].expand(*pos.shape, x_h.shape[-1])
    return torch.gather(x_h, 2, idx)


def forced_ids(
    layout: ShadowLayout, gen_len: torch.Tensor, hit_rate: float, kind: str,
    device,
) -> torch.Tensor:
    """BENCHMARK-ONLY forced selection (JAX ``debug_hit_rate``): a window of
    select_sets chunk ids sliding by m = S * (1 - hit_rate) per decode step,
    so consecutive steps share exactly S - m ids. 'scatter' maps the window
    through the bijection c -> c * mult mod C, mult the first integer from
    4097 up coprime with C; 'contig' keeps the raw window. ``gen_len`` is
    the cache's tensor, read on the device; a [B] one keys the window on its
    largest entry, as JAX does. [S] int32."""
    ssets, c_total = layout.select_sets, layout.chunks
    m = max(1, int(round(ssets * (1.0 - hit_rate))))
    t = gen_len if gen_len.dim() == 0 else gen_len.max()
    ids = (t * m + torch.arange(ssets, device=device)) % c_total
    if kind == "scatter":
        mult = 4097
        while math.gcd(mult, c_total) != 1:
            mult += 1
        ids = (ids * mult) % c_total
    return ids.to(torch.int32)


def shadow_decode_layer(
    model: ModelConfig,
    cache: ShadowCache,
    layer: int,
    q: torch.Tensor,  # [B, Qn, H, Dh] roped queries
    k_new: torch.Tensor,  # [B, Qn, K, Dh] roped new keys
    v_new: torch.Tensor,  # [B, Qn, K, Dh]
    inv_freq_full: torch.Tensor,  # [Dh] f32 (core/rope.py)
    hysteresis: float = 0.0,
    *,
    use_kernel: bool = False,
    ring: bool = False,
    cos_table: torch.Tensor | None = None,  # [>= cs, rope_dim // 2]
    sin_table: torch.Tensor | None = None,
    debug_hit_rate: float | None = None,
    debug_hit_layout: str = "scatter",
    segmented: bool = False,
):
    """One layer's cache update at decode: landmark selection (or the
    forced ``debug_hit_rate`` ids) and the slot-stable assignment
    (``kernels/select.py::select_slots``, one kernel on the card) -> the sparse
    region's refresh -> the new tokens appended to the gen region. Updates
    ``cache`` in place and returns (k_view, v_view, valid_len) with views
    [B, K, cap, Dh] and ``valid_len`` a device tensor shaped as
    ``cache.gen_len``. With ``segmented`` (the XLA-gather branch only) the
    first element is instead the attention segments of
    ``core/attention.py::decode_attention_segments`` — (k, v, base,
    masked) over the static prefix, the sparse region and the gen region,
    views of this layer's buffers — and the second is None, as JAX's
    ``shadow_decode_layer(segmented=True)``.

    The refresh is one of the JAX package's two strategies:

    - ``use_kernel``: the fused refresh kernel rebuilds missed chunks only
      and skips hits (rotating at ``cid*cs + i`` in one stage);
    - otherwise the XLA-gather branch: every selected chunk's rows are
      gathered (``ring``: the chunk-gather kernel; else tensor indexing),
      K is rebuilt and rotated in two stages (offset table, then computed
      chunk-base trig), and hit slots keep their bytes through
      ``where(stay, old, new)``. Only the sparse region is written. With V
      in host memory (bf16 stores) only the missed chunks' V rows are
      read.

    Under a profiler the selection and the refresh (the new rows' append
    and the ids' write included) are the phases ``select`` and
    ``refresh`` (``utils/profiling.py``).
    """
    lo = cache.layout
    b, qn, kh, dh = k_new.shape
    with prof.span(prof.SELECT, q.device):
        q_grouped = q.transpose(1, 2).reshape(b, kh, model.num_groups, qn, dh)
        # Forced ids replace the chosen set after the real scores are
        # computed, so the step pays the selection's cost as a real one does.
        asg = select_slots(
            q_grouped, cache.landmarks[layer], cache.landmark_mask[layer],
            cache.cached_ids[layer], lo.select_sets,
            landmark_scale=(None if cache.lm_scale is None
                            else cache.lm_scale[layer]),
            hysteresis=hysteresis,
            forced_ids=(None if debug_hit_rate is None else forced_ids(
                lo, cache.gen_len, debug_hit_rate, debug_hit_layout,
                q.device)),
        )
    with prof.span(prof.REFRESH, q.device):
        if use_kernel:
            mc, ms, cnt = compact_misses(asg.slot_ids, asg.stay_mask)
            sparse_refresh(
                layer, mc, ms, cnt, cache.u, cache.sv, cache.v_full,
                inv_freq_full, cache.k_buf, cache.v_buf,
                chunk_size=lo.chunk_size, sparse_start=lo.sparse_start,
                rope_dim=model.rope_dim, rope_style=_k_style(model),
                u_scale=cache.u_scale, v_scale=cache.v_scale,
            )
        else:
            k_rows, v_rows = _gather_rebuild(
                model, cache, layer, asg.slot_ids, ring, cos_table, sin_table,
                inv_freq_full, asg.stay_mask,
            )
            stay = asg.stay_mask[..., None, None]  # [B, K, S, 1, 1]
            for buf, new in ((cache.k_buf, k_rows), (cache.v_buf, v_rows)):
                region = buf[layer, :, :, lo.sparse_start:lo.sparse_end].view(
                    b, kh, lo.select_sets, lo.chunk_size, dh)
                region.copy_(torch.where(stay, region, new))
        # The new tokens' rows, from the device counter (no host read).
        row = lo.sparse_end + cache.gen_len
        if row.dim() == 0:
            rows = row.long() + torch.arange(qn, device=row.device)
            cache.k_buf[layer].index_copy_(2, rows, k_new.transpose(1, 2))
            cache.v_buf[layer].index_copy_(2, rows, v_new.transpose(1, 2))
        else:
            _append_gen_rows(cache.k_buf[layer], k_new.transpose(1, 2), row)
            _append_gen_rows(cache.v_buf[layer], v_new.transpose(1, 2), row)
        cache.cached_ids[layer] = asg.slot_ids
    k_l, v_l = cache.k_buf[layer], cache.v_buf[layer]
    if segmented and not use_kernel:
        ss, se = lo.sparse_start, lo.sparse_end
        segs = ((k_l[:, :, :ss], v_l[:, :, :ss], 0, False),
                (k_l[:, :, ss:se], v_l[:, :, ss:se], ss, False),
                (k_l[:, :, se:], v_l[:, :, se:], se, True))
        return segs, None, row + qn
    return k_l, v_l, row + qn


def _k_style(model: ModelConfig) -> str:
    """How the cached layers' keys are rotated: the model's RoPE, or
    ``"none"`` for a model whose full-attention layers are NoPE."""
    return "none" if model.nope_global else model.rope_style


def _append_gen_rows(buf: torch.Tensor, new_t: torch.Tensor,
                     row0: torch.Tensor) -> None:
    """Write new-token rows [B, K, Qn, Dh] into ``buf`` [B, K, cap, Dh] at
    per-slot rows ``row0`` [B] (JAX ``_append_gen_rows``): one scatter on a
    [B, Qn] row index, no host loop over slots. A row past the buffer is
    written to its last row, as JAX's clamped ``dynamic_update_slice``
    does: only a finished slot stepping on to the end of a decode chunk
    gets there, and its rows are never read."""
    b, kh, qn, dh = new_t.shape
    rows = row0.long()[:, None] + torch.arange(qn, device=row0.device)
    rows = rows.clamp(max=buf.shape[2] - 1)
    buf.scatter_(2, rows[:, None, :, None].expand(b, kh, qn, dh), new_t)


def _gather_rebuild(
    model: ModelConfig,
    cache: ShadowCache,
    layer: int,
    slot_ids: torch.Tensor,  # [B, K, S] int32
    ring: bool,
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    inv_freq_full: torch.Tensor,
    stay: torch.Tensor,  # [B, K, S] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The XLA-gather branch's new rows for EVERY slot (JAX
    ``shadow_decode_layer`` :711-941): K rebuilt from the gathered U rows
    and rotated, V dequantized; each [B, K, S, cs, Dh] in the buffer dtype.
    Without ``ring``, a V store in host memory (bf16 stores: JAX's
    ``HostVStore`` path, :865-870) is read for the missed chunks only by
    ``gather_v_rows``, in place on the card; its ``stay`` rows are
    unspecified, and the caller keeps the resident rows there.

    Rounding as in JAX: int8 U goes to the buffer dtype, the product
    accumulates in f32, the per-row scale multiplies the f32 output, then
    one cast; int8 V rows are the exact ``int8 * bf16 scale`` product
    rounded once to the buffer dtype. RoPE rotates by the cs-row offset
    table first, then by the chunk base ``cid * cs``, whose trig is
    computed in f32 from the inverse frequencies and cast to the table
    dtype."""
    lo = cache.layout
    b, kh, s = slot_ids.shape
    cs, dh = lo.chunk_size, cache.v_buf.shape[-1]
    buf_dt = cache.k_buf.dtype
    if ring:
        u_q, v_q, u_sc, v_sc = gather_chunks(
            layer, slot_ids, cache.u, cache.v_full, cache.u_scale,
            cache.v_scale, chunk_size=cs,
        )
    else:
        rows = chunk_ids_to_positions(slot_ids, cs)  # [B, K, S*cs]
        bi = torch.arange(b, device=rows.device)[:, None, None]
        ki = torch.arange(kh, device=rows.device)[None, :, None]
        u_q = cache.u[layer][bi, rows]
        if cache.v_on_host:
            v_q = gather_v_rows(layer, slot_ids, stay, cache.v_full,
                                chunk_size=cs)
        else:
            v_q = cache.v_full[layer][bi, ki, rows]
        if cache.u_scale is not None:
            u_sc = cache.u_scale[layer][bi, rows]
            v_sc = cache.v_scale[layer][bi, ki, rows]
    k_rec = torch.matmul(u_q.to(buf_dt).float(), cache.sv[layer].float())
    if cache.u_scale is not None:
        k_rec = k_rec * u_sc.float()[..., None]
        v_rows = v_q.float() * v_sc.float()[..., None]
    else:
        v_rows = v_q
    k_rec = k_rec.to(buf_dt).view(b, kh, s, cs, dh)
    if _k_style(model) == "none":
        return k_rec, v_rows.to(buf_dt).view(b, kh, s, cs, dh)
    k_rec = rope_lib.rotate_with_tables(
        k_rec, cos_table[:cs], sin_table[:cs], model.rope_style)
    inv = rope_lib.half_inv_freq(inv_freq_full, model)
    base = (slot_ids * cs).float()[..., None, None] * inv  # [B, K, S, 1, half]
    k_rec = rope_lib.rotate_with_tables(
        k_rec, torch.cos(base).to(cos_table.dtype),
        torch.sin(base).to(sin_table.dtype), model.rope_style)
    return k_rec, v_rows.to(buf_dt).view(b, kh, s, cs, dh)

"""The transformer forward pass (counterpart of ``shadowkv_tpu/models/forward.py``).

JAX runs each forward as one ``lax.scan`` over the stacked layer params;
here it is a Python loop over layers. Caches are updated in place. A
decode step reads the cache's position only as a device tensor
(``FullCache.length``, ``ShadowCache.gen_len``): the RoPE rows and the rows
it writes are index ops on it, and it advances by ``add_``, so the step
has the same shapes at every position and can be replayed as one CUDA
graph (``models/engine.py``).

- ``prefill_full`` / ``decode_full``: the full-attention baseline;
- ``prefill_shadow_into`` / ``decode_shadow``: the ShadowKV path (dense
  prefill building the shadow cache, its V store on the card or in host
  memory; sparse decode through the fused refresh kernel or the
  XLA-gather branch, see ``cache/shadow.py``, with decode attention over
  the whole buffer or, ``decode_segmented``, over its segments).

A hybrid model (``ModelConfig.is_hybrid``; one device) runs the same
functions: its caches hold only its full-attention layers (the ``g``-th
of them at cache index ``g``; every layer of a dense model), and
``cache.hybrid`` (``cache/hybrid.py``) its sliding layers' rings, which a
sliding layer writes and attends in the phase ``swa`` (kernel C at window
W, no sink, in the prefill; the decode-attention kernel over the ring in
a step). Its NoPE layers take no RoPE rows; its MoE layers
(``core/moe.py``) group the prefill's tokens by held expert, run the
masked pass over the held experts in a step, and hand their choices to
``cache.hybrid``.

Prefill attention follows ``RuntimeConfig.prefill_pattern`` (JAX
``forward.py`` :244-266 and :544-560): ``"dense"``/``"dense-splash"`` take
the causal kernel B, ``"stream"`` the sink + window kernel C
(``kernels/prefill_attention.py``), ``"vs"`` the MInference per-head
patterns (``core/minference.py``: kernel F for ``vs_impl="tile"``, G for
``"walk"``), with this layer's row of a per-layer table. On CPU tensors
every kernel is its plain version. The JAX engine runs ``"stream"`` as
dense causal attention on the CPU (its splash branch needs an
accelerator); the port's CPU path is kernel C's plain version, so it
applies the window there too.

Parallel ranks (``parallel/mesh.py``) run these functions on their shard
with a head-scaled config: ``tp`` (a process group) makes ``_layer_tail``
all-reduce the o_proj and MLP partial sums and ``_finalize`` all-gather the
vocabulary slices of the logits (JAX ``forward.py`` :176-191, where GSPMD
inserts the same sums). ``prefill_shadow_sp`` is the sequence-parallel
shadow prefill (JAX ``prefill_shadow(sp_mesh=...)``, :324-395).

Under a profiler these functions name their phases (``utils/profiling.py``
``span``): ``embed``, per layer ``qkv``, then the layer's own (decode:
``select`` and ``refresh`` in ``cache/shadow.py``; prefill: ``lowrank`` and
``store``), ``attn``, ``tail``, and ``head`` last; with no profiler a span
costs one check.
"""

from __future__ import annotations

import torch

from shadowkv_tpu_torch.cache.full import FullCache
from shadowkv_tpu_torch.cache.shadow import (
    ShadowCache,
    shadow_decode_layer,
    shadow_prefill_layer,
)
from shadowkv_tpu_torch.config import ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core import minference as mi
from shadowkv_tpu_torch.core import moe as moe_lib
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core import wquant
from shadowkv_tpu_torch.core.attention import (
    decode_attention_hm,
    decode_attention_segments,
)
from shadowkv_tpu_torch.core.layers import (
    Block,
    ModelParams,
    o_proj,
    qkv_proj,
    rms_norm,
    swiglu_mlp,
)
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_offset,
    causal_prefill_splash,
    sparse_prefill_splash,
)
from shadowkv_tpu_torch.parallel import mesh as mesh_lib
from shadowkv_tpu_torch.utils import profiling as prof

_DENSE = RuntimeConfig()


def _layer_qkv(model: ModelConfig, lp: Block, x, cos, sin):
    """Pre-attention compute; returns (q_roped, k_roped, k_pre_rope, v).
    EXAONE 4's block projects the raw residual (no input norm) and
    normalises q and k per head before RoPE; ``cos`` None applies no RoPE
    (a NoPE layer: the roped and pre-RoPE keys are one tensor)."""
    eps = model.rms_norm_eps
    with prof.span(prof.QKV, x.device):
        h = x if model.exaone4_block else rms_norm(x, lp.attn_norm, eps)
        q, k, v = qkv_proj(h, lp, model.num_heads, model.num_kv_heads,
                           model.head_dim)
        if model.exaone4_block:
            q, k = rms_norm(q, lp.q_norm, eps), rms_norm(k, lp.k_norm, eps)
        if cos is None:
            return q, k, k, v
        q_r = rope_lib.apply_rope(q, cos, sin, model.rope_style)
        k_r = rope_lib.apply_rope(k, cos, sin, model.rope_style)
    return q_r, k_r, k, v


def _layer_tail(lp: Block, model: ModelConfig, x, ctx, tp=None,
                static: bool = True, record=None):
    """Post-attention tail; under ``tp`` wo and w_down hold input rows, so
    their products are partial sums that one all-reduce each joins before
    the (replicated) residual stream. EXAONE 4's block normalises the
    attention's and the MLP's outputs before each residual add; an MoE
    layer (``lp.moe``) runs ``core/moe.py`` (``static``: the decode step's
    masked pass, else the prefill's grouped one) and hands its chosen
    expert ids [B, S, k] to ``record``."""
    eps = model.rms_norm_eps
    with prof.span(prof.TAIL, x.device):
        o = o_proj(ctx, lp)
        if tp is not None:
            o = mesh_lib.all_reduce(o, tp)
        if model.exaone4_block:
            o = rms_norm(o, lp.post_attn_norm, eps)
        x = x + o
        if lp.moe is not None:
            m, top = moe_lib.moe(model, lp.moe, x, static)
            if record is not None:
                record(top)
        else:
            h = x if model.exaone4_block else rms_norm(x, lp.mlp_norm, eps)
            m = swiglu_mlp(h, lp)
        if tp is not None:
            m = mesh_lib.all_reduce(m, tp)
        if model.exaone4_block:
            m = rms_norm(m, lp.post_mlp_norm, eps)
        return x + m


def _finalize(model: ModelConfig, params: ModelParams, x, tp=None,
              last_only: bool = True) -> torch.Tensor:
    """Logits in f32: of the last position [B, 1, V] (inference), or of
    every position [B, S, V] with ``last_only=False`` (the trainers).

    For the last position the product is taken in the model dtype: on bf16
    models the logits carry one bf16 rounding, where JAX asks XLA for an
    f32 product; an int8 lm_head's scale multiplies in f32. Every-position
    logits are an f32 product of the model-dtype operands, as JAX's
    ``preferred_element_type=f32``, of a plain lm_head. Under ``tp`` the
    lm_head holds a vocabulary slice and the slices are all-gathered."""
    with prof.span(prof.HEAD, x.device):
        x = rms_norm(x[:, -1:] if last_only else x, params.final_norm,
                     model.rms_norm_eps)
        if last_only:
            logits = wquant.mat(x, params.lm_head, out_dtype=torch.float32)
        else:
            logits = x.float() @ params.lm_head.float()
        if tp is not None:
            logits = mesh_lib.all_gather(logits, tp, dim=-1)
        return logits


def _tables(cos_table, sin_table, n: int):
    """The RoPE rows of a prefill's positions [0, n)."""
    return cos_table[:n], sin_table[:n]


def _decode_tables(cos_table, sin_table, start: torch.Tensor, n: int):
    """The RoPE rows of positions [start, start + n), ``start`` a 0-d
    device tensor ([n, half] rows), or a [B] one of per-sequence starts
    ([B, n, half] rows; a position past the table reads its last row, as
    JAX's clamped take does for a finished slot's overshoot)."""
    steps = torch.arange(n, device=start.device)
    if start.dim() == 0:
        pos = start.long() + steps
        return cos_table.index_select(0, pos), sin_table.index_select(0, pos)
    pos = (start.long()[:, None] + steps).clamp(max=cos_table.shape[0] - 1)
    return cos_table[pos], sin_table[pos]


def _rope_rows(model: ModelConfig, layer: int, cos, sin):
    """The RoPE rows layer ``layer`` applies: none on a NoPE layer."""
    return (None, None) if model.is_nope(layer) else (cos, sin)


def _layers(model: ModelConfig):
    """Each layer with its index among the layers of its attention kind:
    a full-attention layer's row in the cache, a sliding layer's ring."""
    seen = [0, 0]
    for layer in range(model.num_layers):
        kind = int(model.is_sliding(layer))
        yield layer, seen[kind]
        seen[kind] += 1


def _sliding_prefill(model: ModelConfig, hy, ring: int, q, k, v,
                     rows: slice):
    """A sliding layer's prefill: its last W keys and values into ring
    ``ring`` at batch ``rows``, attention over the window by kernel C
    (window W, no sink)."""
    with prof.span(prof.SWA, q.device):
        hy.write_prefill(ring, rows, k, v)
        return sparse_prefill_splash(q, k.contiguous(), v.contiguous(),
                                     model.sliding_window, 0)


def _sliding_step(hy, ring: int, q, k, v, pos):
    """A sliding layer's decode step at positions ``pos``: its key and
    value at ring row ``pos % W``, then attention over the ring."""
    with prof.span(prof.SWA, q.device):
        hy.write_step(ring, pos, k, v)
        return decode_attention_hm(q, hy.ring_k[ring], hy.ring_v[ring],
                                   hy.valid(pos))


def _routes(model: ModelConfig, hy, layer: int, batch_start=None):
    """Where MoE layer ``layer`` hands its chosen experts: the step's
    record, or with ``batch_start`` the prefill's of the rows that
    ``hy.route_rows`` keeps; None on a dense layer."""
    if not model.is_moe(layer):
        return None
    m = model.moe_layers.index(layer)
    if batch_start is None:
        return lambda top: hy.record_step(m, top)
    if not hy.route_rows:
        return None
    return lambda top: hy.record_prefill(m, batch_start, top)


def _one_token(model: ModelConfig, qn: int) -> None:
    if model.sliding_layers and qn != 1:
        raise ValueError("a model with sliding layers decodes one token a "
                         "step")


def check_layer_patterns(rt: RuntimeConfig, model: ModelConfig) -> None:
    """Validate the pattern tables of a ``"vs"`` run (ValueError on a bad
    head count, layer count, kind, or block_sparse in a per-layer table)."""
    if rt.prefill_pattern != "vs":
        return
    if rt.minference_layer_patterns is not None:
        mi.patterns_to_arrays(rt.minference_layer_patterns, model.num_heads,
                              model.num_layers, rt.vs_vertical_size,
                              rt.vs_slash_size)
    else:
        mi.resolve_patterns(rt.minference_patterns, model.num_heads,
                            rt.vs_vertical_size, rt.vs_slash_size)


def prefill_attention(rt: RuntimeConfig, layer: int, q, k, v,
                      sim: "mi.SimShard | None" = None) -> torch.Tensor:
    """The configured prefill attention of one layer; q [B, S, H, Dh], k/v
    [B, S, K, Dh] (contiguous). ``sim``: on a rank mesh, where the call's
    rows, heads and layers lie in one device's ``vs_sim`` draws."""
    if rt.prefill_pattern == "stream":
        return sparse_prefill_splash(q, k, v, rt.stream_window, rt.stream_sink)
    if rt.prefill_pattern != "vs":
        return causal_prefill_splash(q, k, v)
    kw = dict(vertical_size=rt.vs_vertical_size,
              slash_size=rt.vs_slash_size, block=rt.vs_block,
              stream_sink=rt.stream_sink, stream_window=rt.stream_window)
    if rt.minference_layer_patterns is None:
        # The score simulation serves uniform tables only, as in JAX (its
        # per-layer path takes no ``sim``).
        kw.update(patterns=rt.minference_patterns, sim=rt.vs_sim,
                  sim_salt=layer + (sim.layer0 if sim is not None else 0),
                  sim_shard=sim)
    else:
        kw.update(patterns=rt.minference_layer_patterns[layer])
    if rt.vs_impl == "tile":
        return mi.minference_prefill_tile(q, k, v, **kw)
    return mi.minference_prefill(q, k, v, **kw)


# --------------------------------------------------------------------------
# Full-attention baseline
# --------------------------------------------------------------------------


def prefill_full(
    model: ModelConfig,
    params: ModelParams,
    cache: FullCache,
    input_ids: torch.Tensor,  # [Bsub, S]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    batch_start: int = 0,
    rt: RuntimeConfig = _DENSE,
    tp=None,
    sim: "mi.SimShard | None" = None,
) -> torch.Tensor:
    """Prefill of a sub-batch into ``cache`` rows
    [batch_start, batch_start + Bsub); returns last-token logits."""
    b, s = input_ids.shape
    with prof.span(prof.EMBED, input_ids.device):
        x = wquant.take_rows(params.embed, input_ids, model.dtype)
        cos, sin = _tables(cos_table, sin_table, s)
    bs = slice(batch_start, batch_start + b)
    hy = cache.hybrid
    for layer, at in _layers(model):
        lp = params.layer(layer)
        q, k_r, _, v = _layer_qkv(model, lp, x,
                                  *_rope_rows(model, layer, cos, sin))
        if model.is_sliding(layer):
            ctx = _sliding_prefill(model, hy, at, q, k_r, v, bs)
        else:
            with prof.span(prof.STORE, x.device):
                cache.k[at, bs, :, :s] = k_r.transpose(1, 2)
                cache.v[at, bs, :, :s] = v.transpose(1, 2)
            with prof.span(prof.ATTN, x.device):
                ctx = prefill_attention(rt, layer, q, k_r.contiguous(),
                                        v.contiguous(), sim)
        x = _layer_tail(lp, model, x, ctx, tp, static=False,
                        record=_routes(model, hy, layer, batch_start))
    cache.length.fill_(s)
    return _finalize(model, params, x, tp)


def decode_full(
    model: ModelConfig,
    params: ModelParams,
    cache: FullCache,
    tokens: torch.Tensor,  # [B, Qn]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    tp=None,
) -> torch.Tensor:
    b, qn = tokens.shape
    _one_token(model, qn)
    hy = cache.hybrid
    with prof.span(prof.EMBED, tokens.device):
        x = wquant.take_rows(params.embed, tokens, model.dtype)
        start = cache.length
        cos, sin = _decode_tables(cos_table, sin_table, start, qn)
        rows = start.long() + torch.arange(qn, device=start.device)
        new_len = start + qn
    for layer, at in _layers(model):
        lp = params.layer(layer)
        q, k_r, _, v = _layer_qkv(model, lp, x,
                                  *_rope_rows(model, layer, cos, sin))
        if model.is_sliding(layer):
            ctx = _sliding_step(hy, at, q, k_r, v, start)
        else:
            with prof.span(prof.REFRESH, x.device):
                cache.k[at].index_copy_(2, rows, k_r.transpose(1, 2))
                cache.v[at].index_copy_(2, rows, v.transpose(1, 2))
            # Attention over the whole max_length buffer, rows past new_len
            # masked to exactly zero weight, as the JAX full decode does:
            # the shapes stay those of every other step.
            with prof.span(prof.ATTN, x.device):
                ctx = decode_attention_hm(q, cache.k[at], cache.v[at],
                                          new_len)
        x = _layer_tail(lp, model, x, ctx, tp, record=_routes(model, hy,
                                                               layer))
    logits = _finalize(model, params, x, tp)
    cache.length.add_(qn)
    return logits


# --------------------------------------------------------------------------
# ShadowKV sparse path
# --------------------------------------------------------------------------


def shadow_prefill_body(
    model: ModelConfig,
    cache: ShadowCache,
    layer: int,
    lp: Block,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    batch_start: int,
    omega: torch.Tensor | None = None,
    rt: RuntimeConfig = _DENSE,
    tp=None,
    sim: "mi.SimShard | None" = None,
    at: int | None = None,
) -> torch.Tensor:
    """One prefill layer (JAX ``make_shadow_prefill_body``): QKV + RoPE,
    the layer's shadow-cache slices written into ``cache`` at (``at``,
    default ``layer``; batch_start), the configured prefill attention,
    MLP; a sliding layer fills its ring ``at`` instead. Returns the new
    residual. A host V store takes its rows by a synchronous copy from the
    card, so the layer's V rows are on the card only while it runs.
    ``sim`` as in ``prefill_attention``."""
    at = layer if at is None else at
    q, k_r, k_pre, v = _layer_qkv(model, lp, x,
                                  *_rope_rows(model, layer, cos, sin))
    bs = slice(batch_start, batch_start + x.shape[0])
    if model.is_sliding(layer):
        ctx = _sliding_prefill(model, cache.hybrid, at, q, k_r, v, bs)
    else:
        with prof.span(prof.LOWRANK, x.device):
            slices = shadow_prefill_layer(
                model, cache.layout, k_pre, k_r, v, q[:, -1:], omega=omega,
                tp=tp)
        with prof.span(prof.STORE, x.device):
            for name, val in slices.items():
                getattr(cache, name)[at, bs] = val
        with prof.span(prof.ATTN, x.device):
            ctx = prefill_attention(rt, layer, q, k_r.contiguous(),
                                    v.contiguous(), sim)
    return _layer_tail(lp, model, x, ctx, tp, static=False,
                       record=_routes(model, cache.hybrid, layer,
                                      batch_start))


def prefill_shadow_into(
    model: ModelConfig,
    params: ModelParams,
    cache: ShadowCache,
    input_ids: torch.Tensor,  # [Bsub, S]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    batch_start: int = 0,
    omega: torch.Tensor | None = None,
    rt: RuntimeConfig = _DENSE,
    tp=None,
    sim: "mi.SimShard | None" = None,
) -> torch.Tensor:
    """Sub-batch shadow prefill writing into the preallocated full-batch
    cache at ``batch_start``; returns last-token logits [Bsub, 1, V]."""
    b, s = input_ids.shape
    if s != cache.layout.prefill_len:
        raise ValueError("prompt length does not match the cache layout")
    with prof.span(prof.EMBED, input_ids.device):
        x = wquant.take_rows(params.embed, input_ids, model.dtype)
        cos, sin = _tables(cos_table, sin_table, s)
    for layer, at in _layers(model):
        x = shadow_prefill_body(
            model, cache, layer, params.layer(layer), x, cos, sin,
            batch_start, omega, rt, tp, sim, at,
        )
    return _finalize(model, params, x, tp)


def decode_shadow(
    model: ModelConfig,
    params: ModelParams,
    cache: ShadowCache,
    tokens: torch.Tensor,  # [B, Qn]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    inv_freq_full: torch.Tensor,
    hysteresis: float = 0.0,
    use_kernel: bool = False,
    ring: bool = False,
    debug_hit_rate: float | None = None,
    debug_hit_layout: str = "scatter",
    segmented: bool = False,
    tp=None,
) -> torch.Tensor:
    """One sparse decode step over all layers; advances ``cache.gen_len``
    in place.
    ``use_kernel`` picks the fused refresh, else the XLA-gather branch
    (through the chunk-gather kernel with ``ring``; with V in host memory
    and no ``ring``, reading V's missed chunks only). ``segmented`` runs the
    XLA-gather branch's attention over the buffer's segments
    (``decode_attention_segments``; JAX ``forward.py`` :604-677); the fused
    refresh ignores it (JAX :638-640)."""
    b, qn = tokens.shape
    _one_token(model, qn)
    hy = cache.hybrid
    with prof.span(prof.EMBED, tokens.device):
        x = wquant.take_rows(params.embed, tokens, model.dtype)
        pos = cache.kv_len  # the first new token's
        cos, sin = _decode_tables(cos_table, sin_table, pos, qn)
    for layer, at in _layers(model):
        lp = params.layer(layer)
        q, k_r, _, v = _layer_qkv(model, lp, x,
                                  *_rope_rows(model, layer, cos, sin))
        if model.is_sliding(layer):
            ctx = _sliding_step(hy, at, q, k_r, v, pos)
        else:
            k_view, v_view, valid_len = shadow_decode_layer(
                model, cache, at, q, k_r, v, inv_freq_full, hysteresis,
                use_kernel=use_kernel, ring=ring, cos_table=cos_table,
                sin_table=sin_table, debug_hit_rate=debug_hit_rate,
                debug_hit_layout=debug_hit_layout, segmented=segmented,
            )
            with prof.span(prof.ATTN, x.device):
                if v_view is None:
                    ctx = decode_attention_segments(q, k_view, valid_len)
                else:
                    ctx = decode_attention_hm(q, k_view, v_view, valid_len)
        x = _layer_tail(lp, model, x, ctx, tp, record=_routes(model, hy,
                                                               layer))
    logits = _finalize(model, params, x, tp)
    cache.gen_len.add_(qn)
    return logits


def prefill_shadow_sp(
    model: ModelConfig,
    params: ModelParams,
    cache: ShadowCache,
    input_ids: torch.Tensor,  # [B_dp, S]: this dp shard's sequences
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    mesh,
    omega: torch.Tensor | None = None,
) -> torch.Tensor:
    """The sequence-parallel shadow prefill (JAX ``prefill_shadow`` with an
    'sp' mesh, :324-395) of one rank: it embeds and projects its S/sp query
    rows, all-gathers K/V over sp and attends its rows at their global
    offset against all of them (kernel B's offset form), then runs the
    tail. Decode shards the batch over (dp, sp), so the rank builds the
    shadow cache of the B_dp/sp sequences it will decode, ``cache``'s
    batch, from the gathered pre-RoPE K, post-RoPE K and V of those
    sequences (the direct form of JAX's resharding, the same per-sequence
    function). Returns the last-token logits of those sequences."""
    b, s = input_ids.shape
    sp, si = mesh.sp, mesh.coords["sp"]
    if s != cache.layout.prefill_len:
        raise ValueError("prompt length does not match the cache layout")
    if s % sp:
        raise ValueError(f"sp={sp} must divide the prompt length {s}")
    if b % sp:
        raise ValueError(f"batch {b} must divide over sp={sp}")
    sp_g, tp = mesh.groups["sp"], mesh.tp_group
    s_loc, b_dec = s // sp, b // sp
    off = si * s_loc
    mine = slice(si * b_dec, (si + 1) * b_dec)
    with prof.span(prof.EMBED, input_ids.device):
        x = wquant.take_rows(params.embed, input_ids[:, off:off + s_loc],
                             model.dtype)
        cos, sin = cos_table[off:off + s_loc], sin_table[off:off + s_loc]
    for layer in range(model.num_layers):
        lp = params.layer(layer)
        q, k_r, k_pre, v = _layer_qkv(model, lp, x, cos, sin)
        k_all = mesh_lib.all_gather(k_r, sp_g, dim=1)
        v_all = mesh_lib.all_gather(v, sp_g, dim=1)
        k_pre_all = mesh_lib.all_gather(k_pre, sp_g, dim=1)[mine]
        q_last = mesh_lib.all_gather(q[:, -1:], sp_g, dim=1)[:, -1:]
        with prof.span(prof.LOWRANK, x.device):
            slices = shadow_prefill_layer(
                model, cache.layout, k_pre_all, k_all[mine], v_all[mine],
                q_last[mine], omega=omega, tp=tp,
            )
        with prof.span(prof.STORE, x.device):
            for name, val in slices.items():
                getattr(cache, name)[layer] = val
        with prof.span(prof.ATTN, x.device):
            ctx = causal_prefill_offset(q, k_all, v_all, off)
        x = _layer_tail(lp, model, x, ctx, tp)
    # The last token's hidden state lives on the last sp rank.
    logits = _finalize(model, params, x, tp)
    logits = mesh_lib.broadcast(logits.contiguous(),
                                mesh.group_ranks["sp"][-1], sp_g)
    return logits[mine]

"""Pipeline-parallel (pp) shadow prefill and decode (counterpart of
``shadowkv_tpu/parallel/pipeline.py``).

Stage p (one process, with its tp ranks under pp x tp) holds layers
``[p L/pp, (p+1) L/pp)``: their weights and every [L, ...] tensor of the
shadow cache. The schedule is JAX's circular GPipe pipeline: the stage's
batch (its dp rows) splits into M microbatches (``n_micro``); at tick t
stage p runs its layers on microbatch ``t - p`` and hands the activation to
stage p + 1, by ``torch.distributed`` send/recv (``batch_isend_irecv``)
where JAX ``ppermute``s. Stage 0 embeds the tokens; the last stage keeps
the final hidden states, computes the logits and broadcasts them to every
stage, so every stage samples the same tokens from the same generator. The
fill and drain bubble is (pp - 1) / (M + pp - 1) of the schedule.

Scope as in JAX: the HBM shadow cache and the XLA-gather decode branch;
decode runs eagerly, one token per step (JAX ``generate`` uses chunk 1
under pp), since a step's send/recv go through the host on gloo.
"""

from __future__ import annotations

import dataclasses

import torch

from shadowkv_tpu_torch.cache.shadow import ShadowCache, shadow_decode_layer
from shadowkv_tpu_torch.config import ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core import wquant
from shadowkv_tpu_torch.core.attention import decode_attention_hm
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.models import forward
from shadowkv_tpu_torch.parallel import mesh as mesh_lib
from shadowkv_tpu_torch.utils import profiling as prof


def n_micro(batch: int, pp: int) -> int:
    """Microbatches of a stage's batch (JAX ``pipeline.py:276-283``): pp
    when it divides the batch, the batch itself when smaller than pp."""
    if batch % pp == 0:
        return pp
    if batch < pp:
        return batch
    raise ValueError(f"per-dp-shard batch {batch} must be divisible by "
                     f"pp={pp} (or smaller than it)")


def _batch_view(cache: ShadowCache, lo: int, n: int) -> ShadowCache:
    """Rows [lo, lo + n) of every batched cache tensor, as views: the
    decode layer's in-place writes land in ``cache``."""
    rows = {name: getattr(cache, name)[:, lo:lo + n]
            for name in ShadowCache.FIELDS if getattr(cache, name) is not None}
    g = cache.gen_len
    return dataclasses.replace(cache, gen_len=g[lo:lo + n] if g.dim() else g,
                               **rows)


def _run(mesh, batch: int, stage, act_shape, dtype, device):
    """The tick loop: ``stage(m, x_in)`` runs this stage's layers on
    microbatch m (x_in None on stage 0, which embeds) and returns the
    activation [ub, ...]; returns the last stage's activations of every
    microbatch, in order (an empty list on the other stages)."""
    pp, p = mesh.pp, mesh.coords["pp"]
    ranks, group = mesh.group_ranks["pp"], mesh.groups["pp"]
    m_n = n_micro(batch, pp)
    recv = torch.empty(act_shape, dtype=dtype, device=device) if p else None
    outs = []
    for t in range(m_n + pp - 1):
        m = t - p
        y = None
        if 0 <= m < m_n:
            y = stage(m, recv if p else None)
            if p == pp - 1:
                outs.append(y)
        send = y if (y is not None and p < pp - 1) else None
        want = p > 0 and 0 <= t + 1 - p < m_n
        mesh_lib.exchange(
            send, ranks[p + 1] if send is not None else None,
            recv if want else None, ranks[p - 1] if want else None, group)
    return outs


def _logits(model: ModelConfig, params: ModelParams, outs, batch: int,
            mesh, device) -> torch.Tensor:
    """The last stage's logits [B, 1, V] f32, broadcast to every stage."""
    if outs:
        logits = forward._finalize(model, params, torch.cat(outs, dim=0),
                                   mesh.tp_group).contiguous()
    else:
        logits = torch.empty(batch, 1, model.vocab_size, dtype=torch.float32,
                             device=device)
    return mesh_lib.broadcast(logits, mesh.group_ranks["pp"][-1],
                              mesh.groups["pp"])


def prefill_shadow_pp(
    model: ModelConfig,  # the stage's config (local_model)
    params: ModelParams,  # the stage's shard
    cache: ShadowCache,  # the stage's layers, this dp shard's batch
    input_ids: torch.Tensor,  # [B_dp, S]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    mesh,
    omega: torch.Tensor | None = None,
    rt: RuntimeConfig = forward._DENSE,
    sim=None,
) -> torch.Tensor:
    """Whole-batch shadow prefill with the layers pipelined over pp (JAX
    ``prefill_shadow_pp``, ``:81``): each stage runs the sub-batch prefill's
    layer body (``forward.shadow_prefill_body``) for its layers on each
    microbatch and writes its cache slices in place. A stage holds one
    microbatch's [uB, S, D] activations. ``sim`` (``mi.SimShard``) places
    the stage's first row and layer in one device's ``vs_sim`` draws.
    Returns the last-token logits [B_dp, 1, V], on every stage."""
    b, s = input_ids.shape
    if s != cache.layout.prefill_len:
        raise ValueError("prompt length does not match the cache layout")
    ub = b // n_micro(b, mesh.pp)
    cos, sin = cos_table[:s], sin_table[:s]
    tp = mesh.tp_group

    def stage(m, x):
        lo = m * ub
        if x is None:
            with prof.span(prof.EMBED, input_ids.device):
                x = wquant.take_rows(params.embed, input_ids[lo:lo + ub],
                                     model.dtype)
        for layer in range(model.num_layers):
            x = forward.shadow_prefill_body(
                model, cache, layer, params.layer(layer), x, cos, sin, lo,
                omega, rt, tp, None if sim is None else sim.shift(lo))
        return x

    outs = _run(mesh, b, stage, (ub, s, model.hidden_size), model.dtype,
                input_ids.device)
    return _logits(model, params, [y[:, -1:] for y in outs], b, mesh,
                   input_ids.device)


def decode_shadow_pp(
    model: ModelConfig,  # the stage's config (local_model)
    params: ModelParams,
    cache: ShadowCache,
    tokens: torch.Tensor,  # [B_dp, 1]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    inv_freq_full: torch.Tensor,
    mesh,
    hysteresis: float = 0.0,
) -> torch.Tensor:
    """One sparse decode step with the layers pipelined over pp (JAX
    ``decode_shadow_pp``, ``:249``): the layer body of ``decode_shadow``'s
    XLA-gather branch on each microbatch's rows of the cache. Advances
    ``cache.gen_len`` in place; returns logits [B_dp, 1, V] on every
    stage."""
    b, qn = tokens.shape
    if qn != 1:
        raise ValueError("pp decode steps one token at a time")
    m_n = n_micro(b, mesh.pp)
    ub = b // m_n
    cos_all, sin_all = forward._decode_tables(cos_table, sin_table,
                                              cache.kv_len, qn)
    per_slot = cache.gen_len.dim() == 1
    tp = mesh.tp_group

    def stage(m, x):
        lo = m * ub
        view = cache if m_n == 1 else _batch_view(cache, lo, ub)
        cos, sin = ((cos_all[lo:lo + ub], sin_all[lo:lo + ub]) if per_slot
                    else (cos_all, sin_all))
        if x is None:
            with prof.span(prof.EMBED, tokens.device):
                x = wquant.take_rows(params.embed, tokens[lo:lo + ub],
                                     model.dtype)
        for layer in range(model.num_layers):
            lp = params.layer(layer)
            q, k_r, _, v = forward._layer_qkv(model, lp, x, cos, sin)
            k_view, v_view, valid_len = shadow_decode_layer(
                model, view, layer, q, k_r, v, inv_freq_full, hysteresis,
                cos_table=cos_table, sin_table=sin_table)
            with prof.span(prof.ATTN, x.device):
                ctx = decode_attention_hm(q, k_view, v_view, valid_len)
            x = forward._layer_tail(lp, model, x, ctx, tp)
        return x

    outs = _run(mesh, b, stage, (ub, qn, model.hidden_size), model.dtype,
                tokens.device)
    cache.gen_len.add_(qn)
    return _logits(model, params, outs, b, mesh, tokens.device)

"""K-EXAONE's decoder with ShadowKV on its global layers, on one row, in
plain float32 (TF32 off): the reference of the ``hybrid_rounds`` cells.

The block (EXAONE 4.0's, transformers ``models/exaone4``; the MoE of
DeepSeek-V3, ``models/deepseek_v3``), with no input norm: q, k, v
projected from the raw residual, per-head RMSNorm of q and k, rotary
embedding (rotate-half) on sliding layers only, attention, ``x = x +
RMSNorm(o_proj)``, then ``x = x + RMSNorm(mlp(x))`` where the MLP is a
SwiGLU (dense layers) or the MoE: ``s = sigmoid(x W_r)`` in float32, the
top-k of ``s + e_bias`` chosen, weighted by ``s / (sum + 1e-20) *
routed_scaling_factor``; the result is the chosen experts that this device
holds plus the shared expert (one device's share of an expert-parallel
deployment, the share the program computes). Final RMSNorm, untied head.

Attention per layer kind:

- sliding: a query at position p sees the keys p - W + 1 .. p; a decode
  step at depth d of its round sees the prompt's keys after position
  S + d - W and the round's own steps up to d;
- global (NoPE): the prefill's dense causal attention, then ShadowKV as
  ``reference/shadow.py`` defines it, on keys that are never rotated: the
  pre-RoPE keys factored, chunk means of the (unrotated) keys as landmarks,
  outliers, the seed selection of the last prompt query, and each decode
  step's selection; a selected chunk's keys rebuilt as U @ SV.

Like ``reference/shadow.py::RowRun`` the run follows the program's discrete
choices (``follow``: outliers, seed and step chunk ids of the global
layers, and each MoE layer's chosen experts at every prompt position and
step), computing each choice's scores and its own choice beside it.
``prec="fp8"`` is the control: every matmul's operands (projections,
router, experts, head) rounded to float8 e4m3 (``reference/model.py``).
Nothing here imports the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.layout import layout as make_layout
from portbench.reference import model as m
from portbench.reference.shadow import chunk_probs, lowrank


def rope(x, cos, sin):
    """Rotate-half RoPE of x [N, heads, Dh] (cos/sin [N, Dh/2])."""
    half = cos.shape[-1]
    c, s = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_tables(md: dict, positions):
    return m.rope_tables(dict(
        head_dim=md["head_dim"],
        rope_theta=float(md["rope_parameters"]["rope_theta"])), positions)


def window_attention(q, k, v, window, block=512):
    """Causal GQA attention where a query at i sees keys i - window + 1 ..
    i: q [S, H, Dh], k/v [S, K, Dh] -> [S, H, Dh]."""
    s, h, dh = q.shape
    kh = k.shape[1]
    out = torch.empty(s, h, dh, dtype=torch.float32, device=q.device)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        j0 = max(0, i0 - window + 1)
        qb = q[i0:i1].view(i1 - i0, kh, h // kh, dh)
        sc = torch.einsum("ikgd,jkd->kgij", qb, k[j0:i1]) / math.sqrt(dh)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None]
        sc = sc.masked_fill((kj > qi) | (qi - kj >= window), float("-inf"))
        o = torch.einsum("kgij,jkd->ikgd", sc.softmax(-1), v[j0:i1])
        out[i0:i1] = o.reshape(i1 - i0, h, dh)
    return out


def route_regret(scores, bias, chosen) -> float:
    """The worst share of the top-k mass of ``scores + bias`` [N, E] (the
    reference's own router) that chosen experts [N, k] miss."""
    b = scores + bias.float()
    top = b.topk(chosen.shape[-1], dim=-1).values.sum(-1)
    got = b.gather(-1, chosen.long()).sum(-1)
    return float(((top - got) / top).max())


@dataclasses.dataclass
class HybridLayerState:
    """What one layer's pass leaves for the comparisons: ``kind``; for a
    global layer its ShadowKV choices' scores and this run's own choices
    (as ``reference/shadow.py::LayerState``); for an MoE layer the
    router's scores of every prompt position and step [S + T, E] and this
    run's own choice [S + T, k]; for a sliding layer the ring a prefill
    leaves (k, v [K, W, Dh] of the last W positions, k rotated)."""
    kind: str
    out_score: torch.Tensor | None = None
    out_own: torch.Tensor | None = None
    seed_p: torch.Tensor | None = None
    seed_own: torch.Tensor | None = None
    steps_p: torch.Tensor | None = None
    steps_own: torch.Tensor | None = None
    route_s: torch.Tensor | None = None
    route_own: torch.Tensor | None = None
    ring: tuple | None = None


class HybridRowRun:
    """One row's prompt and decode steps through every layer (``steps`` as
    ``RowRun``'s: ``tokens`` [T], ``depth`` [T], ``round`` [T]).

    ``follow``: ``outliers`` [Lg, K, O], ``seed`` [Lg, K, S], ``steps``
    [T, Lg, K, S] chunk ids of the global layers; ``routes`` [Lm, S + T, k]
    the chosen experts of each MoE layer at every prompt position, then
    every step. ``md`` holds the configuration's catalog keys and
    ``held_experts``."""

    def __init__(self, md: dict, cache: dict, w: dict, sketch, prompt,
                 tokens, depth, rounds, prec: str = "f32",
                 follow: dict | None = None, row_block: int = 4096,
                 step_block: int = 32):
        self.md, self.cache, self.w, self.prec = md, cache, w, prec
        self.follow = follow
        self.sketch = sketch.float()
        self.lay = make_layout(cache, prompt.shape[0])
        self.row_block, self.step_block = row_block, step_block
        dev = prompt.device
        s = prompt.shape[0]
        self.s = s
        self.x = w["embed"][prompt].float()
        self.xd = w["embed"][tokens].float()
        self.depth = depth
        self.cos, self.sin = rope_tables(md, torch.arange(s, device=dev))
        self.dcos, self.dsin = rope_tables(md, s + depth)
        same = rounds[:, None] == rounds[None, :]
        self.gen_mask = same & (depth[None, :] <= depth[:, None])  # [T, T]
        self.held = torch.tensor(md["held_experts"], device=dev)
        self.heads = (md["num_attention_heads"], md["num_key_value_heads"],
                      md["head_dim"])

    # -- pieces -------------------------------------------------------------

    def _qkv(self, l, x, cos, sin):
        h, kh, dh = self.heads
        eps = self.md["rms_norm_eps"]
        y = m.linear(x, self.w["wqkv"][l], self.prec)
        q, k, v = y.split([h * dh, kh * dh, kh * dh], dim=-1)
        n = x.shape[0]
        q = m.rms_norm(q.reshape(n, h, dh), self.w["q_norm"][l], eps)
        k = m.rms_norm(k.reshape(n, kh, dh), self.w["k_norm"][l], eps)
        if cos is not None:
            q, k = rope(q, cos, sin), rope(k, cos, sin)
        return q, k, v.reshape(n, kh, dh)

    def _swiglu(self, x, gate_up, down):
        gate, up = m.linear(x, gate_up, self.prec).chunk(2, dim=-1)
        return m.linear(torch.nn.functional.silu(gate) * up, down, self.prec)

    def _moe(self, mi, x, chosen):
        """MoE layer ``mi`` of rows x along ``chosen`` [N, k]: (output,
        scores [N, E], own choice [N, k])."""
        md, w = self.md, self.w
        s = torch.sigmoid(m.linear(x, w["router"][mi], self.prec))
        own = (s + w["e_bias"][mi].float()).topk(
            md["num_experts_per_tok"], dim=-1).indices
        top = own if chosen is None else chosen.long()
        wt = s.gather(-1, top)
        if md["norm_topk_prob"]:
            wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
        wt = wt * md["routed_scaling_factor"]
        out = self._swiglu(x, w["shared_gate_up"][mi], w["shared_down"][mi])
        for j in range(self.held.shape[0]):
            tok, slot = (top == self.held[j]).nonzero(as_tuple=True)
            if tok.numel():
                y = self._swiglu(x[tok], w["experts_gate_up"][mi][j],
                                 w["experts_down"][mi][j])
                out.index_add_(0, tok, y * wt[tok, slot, None])
        return out, s, own

    def _tail(self, l, x, ctx, mi, chosen):
        md, w = self.md, self.w
        eps = md["rms_norm_eps"]
        o = m.linear(ctx.reshape(x.shape[0], -1), w["wo"][l], self.prec)
        x = x + m.rms_norm(o, w["post_attn_norm"][l], eps)
        s = own = None
        if mi is None:
            y = self._swiglu(x, w["dense_gate_up"][self.dense_i],
                             w["dense_down"][self.dense_i])
        else:
            y, s, own = self._moe(mi, x, chosen)
        return x + m.rms_norm(y, w["post_mlp_norm"][l], eps), s, own

    def _follow(self, name, idx, own):
        if self.follow is None:
            return own
        f = self.follow[name]
        return f[idx] if name != "steps" else f[:, idx]

    # -- one layer ------------------------------------------------------------

    def layer(self, l: int, gi: int, si: int, mi: int | None,
              di: int) -> HybridLayerState:
        md = self.md
        sliding = md["layer_types"][l] == "sliding_attention"
        self.dense_i = di
        s, rb = self.s, self.row_block
        cos, sin = (self.cos, self.sin) if sliding else (None, None)
        q, k, v = [], [], []
        for i in range(0, s, rb):
            c = None if cos is None else cos[i:i + rb]
            sn = None if sin is None else sin[i:i + rb]
            qi, ki, vi = self._qkv(l, self.x[i:i + rb], c, sn)
            q.append(qi), k.append(ki), v.append(vi)
        q, k, v = torch.cat(q), torch.cat(k), torch.cat(v)
        win = md["sliding_window"]
        if sliding:
            ctx = window_attention(q, k, v, win)
        else:
            ctx = m.causal_attention(q, k, v, block=256)
        q_last = q[-1]
        del q
        routes = None
        if mi is not None and self.follow is not None:
            routes = self.follow["routes"][mi]
        ss, owns = [], []
        for i in range(0, s, rb):
            blk = slice(i, i + rb)
            ch = None if routes is None else routes[:s][i:i + rb]
            self.x[blk], sc, own = self._tail(l, self.x[blk], ctx[blk], mi, ch)
            ss.append(sc), owns.append(own)
        del ctx
        if sliding:
            st = HybridLayerState(kind="sliding", ring=(
                k[s - win:].permute(1, 0, 2), v[s - win:].permute(1, 0, 2)))
            kv = dict(k_tail=k[s - win:], v_tail=v[s - win:])
        else:
            st, kv = self._shadow_state(gi, k, v, q_last)
        del k, v
        if mi is not None:
            st.route_s, st.route_own = torch.cat(ss), torch.cat(owns)
        if self.xd.shape[0]:
            self._decode_layer(l, gi, mi, sliding, kv, st)
        return st

    def _shadow_state(self, gi, k, v, q_last):
        lay, (_, kh, dh) = self.lay, self.heads
        cs, nc = lay.chunk, lay.chunks
        ctx_rows = nc * cs
        s = k.shape[0]
        u, sv = lowrank(k.reshape(s, kh * dh), self.sketch,
                        self.cache["rank"])
        u = u[:ctx_rows]
        sv = sv.view(-1, kh, dh).permute(1, 0, 2)
        k_ex = k[:ctx_rows].permute(1, 0, 2).contiguous()  # [K, ctx, Dh]
        v_ex = v[:ctx_rows].permute(1, 0, 2).contiguous()
        chunks = k_ex.view(kh, nc, cs, dh)
        lm = chunks.mean(-2)
        cos = torch.einsum("kcd,kcsd->kcs", lm, chunks) / (
            lm.norm(dim=-1)[..., None] * chunks.norm(dim=-1) + 1e-8)
        out_score = -cos.amin(-1)
        out_own = out_score.topk(lay.outliers, dim=-1).indices
        outl = self._follow("outliers", gi, out_own)
        mask = torch.ones(kh, nc, dtype=torch.bool, device=k.device)
        mask.scatter_(-1, outl, False)
        seed_p = chunk_probs(q_last.view(1, kh, -1, dh), lm, mask)[0]
        seed_own = seed_p.topk(lay.sets, dim=-1).indices
        seed = torch.zeros(kh, nc, dtype=torch.bool, device=k.device)
        seed.scatter_(-1, self._follow("seed", gi, seed_own), True)
        k_rec = torch.einsum("nr,krd->knd", u, sv)  # NoPE: never rotated
        orow = (outl[..., None] * cs + torch.arange(cs, device=k.device))
        orow = orow.flatten(1)
        hk = torch.arange(kh, device=k.device)[:, None]
        k_st = torch.cat([k[ctx_rows:].permute(1, 0, 2), k_ex[hk, orow]], 1)
        v_st = torch.cat([v[ctx_rows:].permute(1, 0, 2), v_ex[hk, orow]], 1)
        kv = dict(lm=lm, mask=mask, seed=seed, k_ex=k_ex, v_ex=v_ex,
                  k_rec=k_rec, k_st=k_st, v_st=v_st)
        st = HybridLayerState(kind="global", out_score=out_score,
                              out_own=out_own, seed_p=seed_p,
                              seed_own=seed_own)
        return st, kv

    def _decode_layer(self, l, gi, mi, sliding, kv, st):
        md, lay = self.md, self.lay
        hq, kh, dh = self.heads
        g, cs = hq // kh, lay.chunk
        t = self.xd.shape[0]
        cos, sin = (self.dcos, self.dsin) if sliding else (None, None)
        q, k, v = self._qkv(l, self.xd, cos, sin)
        qg = q.view(t, kh, g, dh)
        scale = 1.0 / math.sqrt(dh)
        ctx = torch.empty(t, hq, dh, device=q.device)
        if sliding:
            win = md["sliding_window"]
            j = torch.arange(self.s - win, self.s, device=q.device)
            seen = j[None] > (self.s + self.depth - win)[:, None]  # [T, W]
            gen = self.gen_mask & (self.depth[:, None] - self.depth[None, :]
                                   < win)
            for i in range(0, t, self.step_block):
                b = slice(i, i + self.step_block)
                s1 = torch.einsum("tkgd,wkd->tkgw", qg[b], kv["k_tail"])
                s1 = s1.masked_fill(~seen[b][:, None, None], float("-inf"))
                s2 = torch.einsum("tkgd,jkd->tkgj", qg[b], k)
                s2 = s2.masked_fill(~gen[b][:, None, None], float("-inf"))
                p = (torch.cat([s1, s2], -1) * scale).softmax(-1)
                o = torch.einsum("tkgw,wkd->tkgd", p[..., :win], kv["v_tail"])\
                    + torch.einsum("tkgj,jkd->tkgd", p[..., win:], v)
                ctx[b] = o.reshape(-1, hq, dh)
        else:
            probs = torch.cat([
                chunk_probs(qg[i:i + self.step_block], kv["lm"], kv["mask"])
                for i in range(0, t, self.step_block)])
            own = probs.topk(lay.sets, dim=-1).indices
            ids = self._follow("steps", gi, own)
            st.steps_p, st.steps_own = probs, own
            sel = torch.zeros(t, kh, lay.chunks, dtype=torch.uint8,
                              device=q.device)
            sel.scatter_(-1, ids, 1)
            exact = kv["seed"][None] & sel.cummin(dim=0).values.bool()
            hk = torch.arange(kh, device=q.device)[None, :, None]
            off = torch.arange(cs, device=q.device)
            for i in range(0, t, self.step_block):
                b = slice(i, i + self.step_block)
                idb = ids[b]
                ex = exact[b].gather(-1, idb)
                rows = (idb[..., None] * cs + off).flatten(2)
                exr = ex[..., None].expand(*ex.shape, cs).flatten(2)[..., None]
                k_sel = torch.where(exr, kv["k_ex"][hk, rows],
                                    kv["k_rec"][hk, rows])
                v_sel = kv["v_ex"][hk, rows]
                qb = qg[b]
                s1 = torch.einsum("tkgd,knd->tkgn", qb, kv["k_st"])
                s2 = torch.einsum("tkgd,tknd->tkgn", qb, k_sel)
                s3 = torch.einsum("tkgd,jkd->tkgj", qb, k)
                s3 = s3.masked_fill(~self.gen_mask[b][:, None, None],
                                    float("-inf"))
                n1, n2 = s1.shape[-1], s2.shape[-1]
                p = (torch.cat([s1, s2, s3], -1) * scale).softmax(-1)
                o = torch.einsum("tkgn,knd->tkgd", p[..., :n1], kv["v_st"]) \
                    + torch.einsum("tkgn,tknd->tkgd", p[..., n1:n1 + n2],
                                   v_sel) \
                    + torch.einsum("tkgj,jkd->tkgd", p[..., n1 + n2:], v)
                ctx[b] = o.reshape(-1, hq, dh)
        routes = None
        if mi is not None and self.follow is not None:
            routes = self.follow["routes"][mi][self.s:]
        self.xd, sc, own = self._tail(l, self.xd, ctx, mi, routes)
        if mi is not None:
            st.route_s = torch.cat([st.route_s, sc])
            st.route_own = torch.cat([st.route_own, own])

    # -- the ends -------------------------------------------------------------

    def run_layers(self):
        """Every layer in turn; yields (layer, global index or None, MoE
        index or None, state)."""
        gi = si = mi = di = 0
        for l, kind in enumerate(self.md["layer_types"]):
            moe = self.md["mlp_layer_types"][l] == "sparse"
            sliding = kind == "sliding_attention"
            st = self.layer(l, gi, si, mi if moe else None, di)
            yield (l, None if sliding else gi, mi if moe else None, st)
            gi += not sliding
            si += sliding
            mi += moe
            di += not moe

    def logits(self):
        """(the prompt's last-token logits [V], each step's [T, V])."""
        md = dict(rms_norm_eps=self.md["rms_norm_eps"])
        pre = m.logits(md, self.w, self.x[-1:], self.prec)[0]
        if not self.xd.shape[0]:
            return pre, self.xd.new_zeros(0, pre.shape[0])
        return pre, m.logits(md, self.w, self.xd, self.prec)

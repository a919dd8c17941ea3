"""ShadowKV on one row, in plain float32: the prefill of a prompt and the
sparse decode of teacher-forced tokens after it, as the ShadowKV paper
(Sun et al., 2024, arXiv:2410.21465) defines them:

- prefill: dense causal attention; per layer the pre-RoPE keys factored
  as K ~= U @ SV (rank ``rank``; a randomized range finder with one power
  pass over the given Gaussian sketch, then the top singular directions of
  the projected keys); post-RoPE chunk means as landmarks; the
  ``outlier_chunks`` chunks whose least token-to-mean cosine is lowest
  kept exact; the last rows kept dense; the sparse budget seeded with the
  exact rows of the chunks the last prompt query selects;
- decode: each step scores the landmarks (softmax over chunks at a fixed
  1/sqrt(128), the largest over a KV head's query group), keeps the top
  ``sparse_budget / chunk`` chunks, and attends the dense rows, the
  outliers, the selected chunks and this round's generated rows. A
  selected chunk's keys are rebuilt from U @ SV and rotated at their
  positions, its values read from the V store, except that a seed chunk
  selected at every step since the prefill keeps its exact rows.

With ``kv_quant="int8"`` U, the V store and the landmarks are stored as
symmetric int8 rows (``round(x / s)`` clipped to 127, ``s = amax / 127``;
U's and V's scales kept in bfloat16), and read dequantized.

``RowRun`` advances one layer at a time over the prompt and the decode
steps together, so only one layer's state is alive; two runs (the
reference and its fp8 control) can be stepped side by side. Nothing here
imports the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.layout import layout as make_layout
from portbench.reference import model as m


def lowrank(k_pre: torch.Tensor, omega: torch.Tensor, rank: int):
    """U [S, rank], SV [rank, d] of pre-RoPE keys k_pre [S, d] (float32):
    Q spans K K^T K omega (re-orthonormalized by QR), then the top
    ``rank`` singular directions of Q^T K."""
    q = torch.linalg.qr(k_pre @ omega).Q
    z = torch.linalg.qr(k_pre.T @ q).Q
    q = torch.linalg.qr(k_pre @ z).Q
    ub, sb, vbt = torch.linalg.svd(q.T @ k_pre, full_matrices=False)
    return q @ ub[:, :rank], sb[:rank, None] * vbt[:rank]


def int8_rows(x: torch.Tensor, bf16_scale: bool) -> torch.Tensor:
    """x rounded through the int8 row format (the last axis is a row)."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / s), -127, 127)
    if bf16_scale:
        s = s.to(torch.bfloat16).float()
    return q * s


def chunk_probs(qg: torch.Tensor, lm: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Selection scores [N, K, C] of grouped queries qg [N, K, G, Dh] over
    landmarks lm [K, C, Dh] (mask [K, C]: False at outliers); a step keeps
    the top ``sets`` of them."""
    sc = torch.einsum("nkgd,kcd->nkgc", qg, lm) / math.sqrt(128.0)
    sc = sc.masked_fill(~mask[None, :, None], float("-inf"))
    return sc.softmax(-1).amax(-2)


@dataclasses.dataclass
class LayerState:
    """A layer's ShadowKV state, for comparisons with the port's cache, and
    its three choices: each with the scores it is made from and the ids
    this run would choose (``*_own``), which a followed run does not use."""
    k_pre_ctx: torch.Tensor  # [ctx, K*Dh] pre-RoPE context keys
    u: torch.Tensor  # [ctx, rank] (dequantized)
    sv: torch.Tensor  # [K, rank, Dh]
    landmarks: torch.Tensor  # [K, C, Dh] (dequantized)
    out_score: torch.Tensor  # [K, C] -(least token-to-mean cosine)
    out_own: torch.Tensor  # [K, O]
    seed_p: torch.Tensor  # [K, C] the last prompt query's chunk scores
    seed_own: torch.Tensor  # [K, S]
    steps_p: torch.Tensor | None = None  # [T, K, C] each step's scores
    steps_own: torch.Tensor | None = None  # [T, K, S]
    # the stores as the decode reads them: k_ex / v_ex [K, ctx, Dh] exact
    # context rows, v_store [K, ctx, Dh] (rounded where int8), k_st / v_st
    # [K, static rows, Dh] the local rows then the outlier chunks' rows
    kv: dict | None = None


class RowRun:
    """One row's prompt and decode steps through every layer.

    ``steps``: ``tokens`` [T] fed at each decode step, ``depth`` [T] the
    step's place in its round (the gen region holds the round's rows
    0..depth), ``round`` [T] the round; steps in order.

    ``follow`` makes the run take another run's discrete choices instead
    of its own: ``outliers`` [L, K, O], ``seed`` [L, K, S] and ``steps``
    [T, L, K, S] chunk ids. Near-ties make an exact reproduction of
    another precision's choices impossible, so the arithmetic is compared
    along the judged run's choices and each choice is judged on its own
    (``reference/compare.py``)."""

    def __init__(self, model: dict, cache: dict, w: dict, sketch: torch.Tensor,
                 prompt: torch.Tensor, tokens: torch.Tensor,
                 depth: torch.Tensor, rounds: torch.Tensor, prec: str = "f32",
                 follow: dict | None = None, row_block: int = 4096,
                 step_block: int = 32):
        self.model, self.cache, self.w, self.prec = model, cache, w, prec
        self.follow = follow
        self.sketch = sketch.float()
        self.lay = make_layout(cache, prompt.shape[0])
        self.quant = cache["kv_quant"] == "int8"
        dev = prompt.device
        self.row_block, self.step_block = row_block, step_block
        s = prompt.shape[0]
        self.x = w["embed"][prompt].float()  # [S, D]
        self.xd = w["embed"][tokens].float()  # [T, D]
        self.cos, self.sin = m.rope_tables(model, torch.arange(s, device=dev))
        self.dcos, self.dsin = m.rope_tables(model, s + depth)
        same = rounds[:, None] == rounds[None, :]
        self.gen_mask = same & (depth[None, :] <= depth[:, None])  # [T, T]

    # -- one layer ----------------------------------------------------------

    def layer(self, l: int) -> LayerState:
        md, w, prec = self.model, self.w, self.prec
        style, eps = md["rope_style"], md["rms_norm_eps"]
        s = self.x.shape[0]
        q, k, v = [], [], []
        for i in range(0, s, self.row_block):
            h = m.rms_norm(self.x[i:i + self.row_block], w["attn_norm"][l], eps)
            qi, ki, vi = m.qkv(md, w, l, h, prec)
            q.append(qi), k.append(ki), v.append(vi)
        q, k_pre, v = torch.cat(q), torch.cat(k), torch.cat(v)
        qr = m.apply_rope(q, self.cos, self.sin, style)
        kr = m.apply_rope(k_pre, self.cos, self.sin, style)
        del q
        ctx = m.causal_attention(qr, kr, v)
        for i in range(0, s, self.row_block):
            blk = slice(i, i + self.row_block)
            self.x[blk] = m.block_tail(md, w, l, self.x[blk], ctx[blk], prec)
        del ctx
        state, kv = self._shadow_state(l, k_pre, kr, v, qr[-1])
        del qr
        if self.xd.shape[0]:
            state.steps_p, state.steps_own = self._decode_layer(l, kv)
        return state

    def _choice(self, name: str, l: int, own: torch.Tensor) -> torch.Tensor:
        if self.follow is None:
            return own
        return self.follow[name][l] if name != "steps" \
            else self.follow[name][:, l]

    def _shadow_state(self, l, k_pre, kr, v, q_last):
        md, lay = self.model, self.lay
        kh, dh = md["num_kv_heads"], md["head_dim"]
        cs, nc = lay.chunk, lay.chunks
        ctx_rows = nc * cs
        s = k_pre.shape[0]
        u, sv = lowrank(k_pre.reshape(s, kh * dh), self.sketch,
                        self.cache["rank"])
        u = u[:ctx_rows]
        sv = sv.view(-1, kh, dh).permute(1, 0, 2)  # [K, rank, Dh]
        k_ex = kr[:ctx_rows].permute(1, 0, 2).contiguous()  # [K, ctx, Dh]
        v_ex = v[:ctx_rows].permute(1, 0, 2).contiguous()
        chunks = k_ex.view(kh, nc, cs, dh)
        lm = chunks.mean(-2)  # [K, C, Dh]
        cos = torch.einsum("kcd,kcsd->kcs", lm, chunks) / (
            lm.norm(dim=-1)[..., None] * chunks.norm(dim=-1) + 1e-8)
        out_score = -cos.amin(-1)
        out_own = out_score.topk(lay.outliers, dim=-1).indices  # [K, O]
        outl = self._choice("outliers", l, out_own)
        mask = torch.ones(kh, nc, dtype=torch.bool, device=k_pre.device)
        mask.scatter_(-1, outl, False)
        # the seed selection reads the landmarks before they are stored
        seed_p = chunk_probs(q_last.view(1, kh, -1, dh), lm, mask)[0]
        seed_own = seed_p.topk(lay.sets, dim=-1).indices
        seed = torch.zeros(kh, nc, dtype=torch.bool, device=k_pre.device)
        seed.scatter_(-1, self._choice("seed", l, seed_own), True)
        if self.quant:
            u = int8_rows(u, bf16_scale=True)
            v_store = int8_rows(v_ex, bf16_scale=True)
            lm = int8_rows(lm, bf16_scale=False)
        else:
            v_store = v_ex
        k_rec = torch.einsum("nr,krd->knd", u, sv)
        k_rec = m.apply_rope(k_rec.permute(1, 0, 2), self.cos[:ctx_rows],
                             self.sin[:ctx_rows], md["rope_style"])
        k_rec = k_rec.permute(1, 0, 2)  # [K, ctx, Dh]
        # The rows every step attends: the dense local rows, then the
        # outlier chunks' exact rows.
        orow = (outl[..., None] * cs + torch.arange(cs, device=outl.device))
        orow = orow.flatten(1)  # [K, O*cs]
        hk = torch.arange(kh, device=outl.device)[:, None]
        k_st = torch.cat([kr[ctx_rows:].permute(1, 0, 2), k_ex[hk, orow]], 1)
        v_st = torch.cat([v[ctx_rows:].permute(1, 0, 2), v_ex[hk, orow]], 1)
        kv = dict(lm=lm, mask=mask, seed=seed, k_ex=k_ex, v_ex=v_ex,
                  k_rec=k_rec, v_store=v_store, k_st=k_st, v_st=v_st)
        state = LayerState(k_pre_ctx=k_pre[:ctx_rows].reshape(ctx_rows, -1),
                           u=u, sv=sv, landmarks=lm, out_score=out_score,
                           out_own=out_own, seed_p=seed_p, seed_own=seed_own,
                           kv=kv)
        return state, kv

    def _decode_layer(self, l: int, kv: dict):
        """The decode steps through layer ``l``; returns each step's chunk
        scores [T, K, C] and this run's own choice [T, K, S]."""
        md, w, prec, lay = self.model, self.w, self.prec, self.lay
        kh, dh, hq = md["num_kv_heads"], md["head_dim"], md["num_heads"]
        g, cs = hq // kh, lay.chunk
        t = self.xd.shape[0]
        h = m.rms_norm(self.xd, w["attn_norm"][l], md["rms_norm_eps"])
        q, k, v = m.qkv(md, w, l, h, prec)
        q = m.apply_rope(q, self.dcos, self.dsin, md["rope_style"])
        k = m.apply_rope(k, self.dcos, self.dsin, md["rope_style"])
        qg = q.view(t, kh, g, dh)
        probs = torch.cat([chunk_probs(qg[i:i + self.step_block], kv["lm"],
                                       kv["mask"])
                           for i in range(0, t, self.step_block)])  # [T,K,C]
        own = probs.topk(lay.sets, dim=-1).indices
        ids = self._choice("steps", l, own)  # [T, K, S]
        sel = torch.zeros(t, kh, lay.chunks, dtype=torch.uint8,
                          device=q.device)
        sel.scatter_(-1, ids, 1)
        # a seed chunk is exact while it has been selected at every step
        exact = kv["seed"][None] & sel.cummin(dim=0).values.bool()
        hk = torch.arange(kh, device=q.device)[None, :, None]
        off = torch.arange(cs, device=q.device)
        scale = 1.0 / math.sqrt(dh)
        ctx = torch.empty(t, hq, dh, device=q.device)
        for i in range(0, t, self.step_block):
            b = slice(i, i + self.step_block)
            idb = ids[b]
            ex = exact[b].gather(-1, idb)  # [bt, K, S]
            rows = (idb[..., None] * cs + off).flatten(2)  # [bt, K, S*cs]
            exr = ex[..., None].expand(*ex.shape, cs).flatten(2)[..., None]
            k_sel = torch.where(exr, kv["k_ex"][hk, rows], kv["k_rec"][hk, rows])
            v_sel = torch.where(exr, kv["v_ex"][hk, rows],
                                kv["v_store"][hk, rows])
            qb = qg[b]
            s1 = torch.einsum("tkgd,knd->tkgn", qb, kv["k_st"])
            s2 = torch.einsum("tkgd,tknd->tkgn", qb, k_sel)
            s3 = torch.einsum("tkgd,jkd->tkgj", qb, k)
            s3 = s3.masked_fill(~self.gen_mask[b][:, None, None],
                                float("-inf"))
            n1, n2 = s1.shape[-1], s2.shape[-1]
            p = (torch.cat([s1, s2, s3], -1) * scale).softmax(-1)
            o = torch.einsum("tkgn,knd->tkgd", p[..., :n1], kv["v_st"]) \
                + torch.einsum("tkgn,tknd->tkgd", p[..., n1:n1 + n2], v_sel) \
                + torch.einsum("tkgj,jkd->tkgd", p[..., n1 + n2:], v)
            ctx[b] = o.reshape(-1, hq, dh)
        self.xd = m.block_tail(md, w, l, self.xd, ctx, prec)
        return probs, own

    # -- the ends -----------------------------------------------------------

    def run_layers(self):
        """Every layer in turn; yields each layer's state."""
        for l in range(self.model["num_layers"]):
            yield self.layer(l)

    def logits(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(the prompt's last-token logits [V], each decode step's logits
        [T, V]), float32, after every layer has run."""
        pre = m.logits(self.model, self.w, self.x[-1:], self.prec)[0]
        if not self.xd.shape[0]:
            return pre, self.xd.new_zeros(0, pre.shape[0])
        return pre, m.logits(self.model, self.w, self.xd, self.prec)

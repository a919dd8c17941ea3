"""The numbers a run compares with the reference, each judged against its
limit in ``portbench/limits/<cell>.json`` (a number passes at or below its
limit). The program's outputs come in as float32 tensors; the reference
reads them only to judge them."""

from __future__ import annotations

import torch

from portbench.reference.shadow import LayerState


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The largest amount by which a greedy token's reference logit lies
    below the reference's best at its position: ref_logits [N, V], tokens
    [N] (the program's, or the control's, choice at each position)."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def logit_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest logit difference over the reference logits' spread."""
    return float((prog.float() - ref).abs().max() / ref.std())


def lowrank_excess(state: LayerState, u: torch.Tensor,
                   sv: torch.Tensor) -> float:
    """How much worse factors (u [ctx, rank], sv [K, rank, Dh]) rebuild the
    layer's pre-RoPE context keys than the reference's own factors do:
    ||K - u sv|| / ||K - U SV|| - 1 (a rotation inside the factors'
    subspace changes nothing)."""
    k = state.k_pre_ctx

    def err(uu, ss):
        rec = torch.einsum("nr,krd->nkd", uu.float(), ss.float())
        return (k - rec.reshape(k.shape)).norm()

    return float(err(u, sv) / err(state.u, state.sv) - 1.0)


def landmark_err(state: LayerState, lm: torch.Tensor) -> float:
    """Relative Frobenius distance of landmarks lm [K, C, Dh] from the
    reference's."""
    ref = state.landmarks
    return float((lm.float() - ref).norm() / ref.norm())


def select_regret(p: torch.Tensor, chosen: torch.Tensor) -> float:
    """The worst share of the best selection's score mass that a chosen
    set of chunks misses: p [..., C] the reference's chunk scores, chosen
    [..., S] ids; (mass of the top S - mass of the chosen) / mass of the
    top S, the largest over the leading positions. Swaps at near-ties cost
    almost nothing; a wrong selection costs much."""
    top = p.topk(chosen.shape[-1], dim=-1).values.sum(-1)
    got = p.gather(-1, chosen.long()).sum(-1)
    return float(((top - got) / top).max())


def outlier_gap(score: torch.Tensor, chosen: torch.Tensor) -> float:
    """How far below the reference's outlier threshold a chosen outlier's
    score lies: score [K, C] the reference's outlier scores (minus the
    chunk's least token-to-mean cosine), chosen [K, O] ids; the largest
    over heads of (the O-th highest score - a chosen chunk's score), 0
    when the chosen are the reference's."""
    tau = score.topk(chosen.shape[-1], dim=-1).values[..., -1:]
    return float((tau - score.gather(-1, chosen.long())).clamp(min=0).max())


def store_err(state: LayerState, v: torch.Tensor) -> float:
    """Relative Frobenius distance of a V store v [K, ctx, Dh]
    (dequantized) from the reference's."""
    ref = state.kv["v_store"]
    return float((v.float() - ref).norm() / ref.norm())


def buffer_err(state: LayerState, lay, k: torch.Tensor, v: torch.Tensor,
               seed: torch.Tensor) -> float:
    """The worst relative Frobenius distance, K and V apart, of the rows a
    prefill writes into the compact buffer (k, v [K, rows, Dh], the first
    rows up to the sparse budget's end) from the reference's exact rows:
    the local rows, the outlier chunks and the seed chunks at their slots
    (seed [K, S] the chunk ids held there). The buffer's order of the
    outlier chunks is free, so each outlier chunk is matched both ways to
    the nearest on the other side; a chunk written wrong or twice has no
    near match."""
    kv = state.kv
    pl, cs, o = lay.local_rows, lay.chunk, lay.outliers
    so = pl + o * cs
    kh, dh = k.shape[0], k.shape[-1]
    dev = k.device
    rows = (seed.long()[..., None] * cs
            + torch.arange(cs, device=dev)).flatten(1)  # [K, S*cs]
    hk = torch.arange(kh, device=dev)[:, None]
    prog = {"k": k.float(), "v": v.float()}
    ref = {"k": (kv["k_st"], kv["k_ex"]), "v": (kv["v_st"], kv["v_ex"])}

    def chunks(x):  # outlier rows [K, O*cs, Dh] -> [K, O, cs*Dh]
        return x.reshape(kh, o, cs * dh)

    pc = torch.cat([chunks(prog["k"][:, pl:so]), chunks(prog["v"][:, pl:so])],
                   -1)
    rc = torch.cat([chunks(kv["k_st"][:, pl:]), chunks(kv["v_st"][:, pl:])],
                   -1)
    dist = torch.cdist(pc, rc)  # [K, O, O]
    near_r, near_p = dist.argmin(-1), dist.argmin(-2)
    worst = 0.0
    for x in ("k", "v"):
        st, ex = ref[x]
        p = prog[x]
        pr, rr = chunks(p[:, pl:so]), chunks(st[:, pl:])
        out = torch.maximum((pr - rr.gather(1, near_r[..., None].expand_as(pr)))
                            .norm(), (rr - pr.gather(1, near_p[..., None]
                                                     .expand_as(rr))).norm())
        local = (p[:, :pl] - st[:, :pl]).norm()
        sd = (p[:, so:] - ex[hk, rows]).norm()
        whole = torch.cat([st, ex[hk, rows]], 1).norm()
        err = (local ** 2 + out ** 2 + sd ** 2).sqrt() / whole
        worst = max(worst, float(err))
    return worst

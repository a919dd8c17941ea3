"""Token sampling: greedy, or temperature with top-k / top-p
(counterpart of ``shadowkv_tpu/core/sampling.py``). Temperature sampling
draws from an explicit ``torch.Generator`` (JAX draws from a PRNG key, so
the two packages sample different tokens from the same seed).

The draw is ``torch.multinomial``'s own one-sample method written out:
argmax of ``probs / q`` with ``q ~ Exp(1)``. It takes the same numbers from
the generator and gives the same token, without the host reads that
``multinomial`` makes to check its input, so the step can be captured in a
CUDA graph (the graph then advances the generator on every replay).

A data-parallel rank holds some rows of the batch: ``rows=(first,
batch)`` draws the whole batch's numbers and keeps its own, so the ranks
together sample what one device samples from the same generator."""

from __future__ import annotations

import torch

_NEG_INF = torch.finfo(torch.float32).min


def top_k_top_p_filter(
    logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0
) -> torch.Tensor:
    """Mask logits [B, V] (f32) outside the top-k / nucleus-p sets; the
    highest-probability token is always kept."""
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        exceeded = cum_probs > top_p
        exceeded = torch.cat(
            [torch.zeros_like(exceeded[..., :1]), exceeded[..., :-1]], dim=-1
        )
        kept_sorted = torch.where(exceeded, torch.inf, sorted_logits)
        threshold = kept_sorted.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, _NEG_INF, logits)
    return logits


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: int = 50,
    top_p: float = 0.9,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Next token ids [B] (int32) from logits [B, V]; ``rows=(first,
    batch)``: these are rows [first, first + B) of a batch of ``batch``."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = top_k_top_p_filter(logits / temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logits, dim=-1)
    if rows is None:
        q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    else:
        first, batch = rows
        q = probs.new_empty((batch, probs.shape[-1])).exponential_(
            1.0, generator=generator)[first:first + probs.shape[0]]
    return torch.argmax(probs / q, dim=-1).to(torch.int32)

"""Chunk landmarks, outliers, top-k selection and slot-stable reuse.

Counterpart of ``shadowkv_tpu/core/selection.py`` plus ``compact_misses``
(plain jnp in ``shadowkv_tpu/kernels/reconstruct.py``). Shapes use B=batch,
K=kv heads, G=GQA group, C=chunks, S=select_sets.

Top-k is always exact (``torch.topk``): the JAX package's ``approx=True``
is the TPU's ``approx_max_k``, which JAX also computes exactly on the CPU.
Only the MEMBERSHIP of the selected set matters downstream, since
``assign_slots_stable`` sorts incoming ids.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LandmarkState(NamedTuple):
    landmarks: torch.Tensor  # [B, K, C, Dh] post-RoPE chunk means
    landmark_mask: torch.Tensor  # [B, K, C] bool, False at outlier chunks
    outlier_idx: torch.Tensor  # [B, K, O] int64 outlier chunk ids


def compute_landmarks_outliers(
    k_roped_ctx: torch.Tensor, outlier_chunks: int
) -> LandmarkState:
    """Chunk means of post-RoPE K as landmarks; the ``outlier_chunks``
    chunks whose minimum token-to-mean cosine similarity is lowest are
    outliers (masked out of the landmark table).

    Args:
      k_roped_ctx: [B, K, C, chunk_size, Dh].
    """
    kf = k_roped_ctx.float()
    means = kf.mean(dim=-2)  # [B, K, C, Dh]
    dots = torch.einsum("bkcd,bkcsd->bkcs", means, kf)
    denom = (
        torch.linalg.vector_norm(means, dim=-1)[..., None]
        * torch.linalg.vector_norm(kf, dim=-1)
        + 1e-8
    )
    min_sim = (dots / denom).amin(dim=-1)  # [B, K, C]
    outlier_idx = torch.topk(-min_sim, outlier_chunks, dim=-1).indices
    mask = torch.ones_like(min_sim, dtype=torch.bool)
    mask.scatter_(-1, outlier_idx, False)
    return LandmarkState(means.to(k_roped_ctx.dtype), mask, outlier_idx)


def landmark_probs(
    query: torch.Tensor,
    landmarks: torch.Tensor,
    landmark_mask: torch.Tensor,
    landmark_scale: torch.Tensor | None = None,
    resident_ids: torch.Tensor | None = None,
    hysteresis: float = 0.0,
) -> torch.Tensor:
    """Each chunk's selection prob (``score_and_select``'s before its top-k):
    a fixed 1/sqrt(128) scale whatever head_dim is, an f32 softmax over
    landmarks (outliers at -inf), a SUM over query positions, then a MAX
    over the GQA group. ``landmark_scale`` [B, K, C] (f32) rescales int8
    landmark rows; ``hysteresis`` boosts chunks in ``resident_ids``
    [B, K, S] by a relative margin.

    Args:
      query: [B, K, G, Q, Dh]; landmarks: [B, K, C, Dh].
    Returns:
      [B, K, C] f32.
    """
    scores = torch.einsum(
        "bkgqd,bkcd->bkgqc", query.float(), landmarks.float()
    ) / math.sqrt(128.0)
    if landmark_scale is not None:
        scores = scores * landmark_scale[:, :, None, None, :]
    scores = torch.where(landmark_mask[:, :, None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1).sum(dim=-2).amax(dim=-2)  # [B,K,C]
    if resident_ids is not None and hysteresis:
        res = torch.zeros_like(probs, dtype=torch.bool)
        res.scatter_(-1, resident_ids.long(), True)
        probs = probs * (1.0 + hysteresis * res.to(probs.dtype))
    return probs


def score_and_select(
    query: torch.Tensor,
    landmarks: torch.Tensor,
    landmark_mask: torch.Tensor,
    select_sets: int,
    landmark_scale: torch.Tensor | None = None,
    resident_ids: torch.Tensor | None = None,
    hysteresis: float = 0.0,
) -> torch.Tensor:
    """Score landmarks against the queries (``landmark_probs``) and return
    the top chunk ids, [B, K, select_sets] int32."""
    probs = landmark_probs(query, landmarks, landmark_mask, landmark_scale,
                           resident_ids, hysteresis)
    return torch.topk(probs, select_sets, dim=-1).indices.to(torch.int32)


class SlotAssignment(NamedTuple):
    slot_ids: torch.Tensor  # [B, K, S] chunk id occupying each slot
    stay_mask: torch.Tensor  # [B, K, S] True where the slot's chunk stays
    stay_count: torch.Tensor  # [B, K] int32


def assign_slots_stable(
    prev_slot_ids: torch.Tensor, new_ids: torch.Tensor
) -> SlotAssignment:
    """Slot-stable reuse: re-selected chunks keep their slot; incoming
    chunks fill the vacated slots (ascending slot order) in ASCENDING
    chunk-id order, so the compacted miss list is sorted in both slot and
    chunk space (the refresh kernel's contiguous-run invariant)."""
    stay = (prev_slot_ids[..., :, None] == new_ids[..., None, :]).any(-1)
    incoming = ~(new_ids[..., :, None] == prev_slot_ids[..., None, :]).any(-1)
    vac_rank = torch.cumsum((~stay).to(torch.int32), dim=-1) - 1
    pad = torch.full_like(new_ids, 2**30)
    incoming_sorted = torch.sort(torch.where(incoming, new_ids, pad), dim=-1).values
    new_for_slot = take_small_int(incoming_sorted, vac_rank.clamp(min=0))
    slot_ids = torch.where(stay, prev_slot_ids, new_for_slot)
    return SlotAssignment(slot_ids, stay, stay.sum(-1).to(torch.int32))


def take_small_int(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[..., idx] along the last dim (the JAX version is a one-hot
    select-reduce because TPU gathers of narrow int rows are slow; here a
    plain gather)."""
    return torch.gather(arr, -1, idx.long())


def chunk_ids_to_positions(
    chunk_ids: torch.Tensor, chunk_size: int
) -> torch.Tensor:
    """[B, K, S] chunk ids -> [B, K, S * chunk_size] token positions."""
    offs = torch.arange(chunk_size, device=chunk_ids.device)
    pos = chunk_ids.long()[..., None] * chunk_size + offs
    return pos.reshape(*chunk_ids.shape[:-1], -1)


def compact_misses(
    slot_ids: torch.Tensor, stay_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack miss slots first with a STABLE sort on the stay flag, so misses
    keep ascending slot (and, after ``assign_slots_stable``, chunk) order.
    Returns int32 (miss_chunk, miss_slot, miss_cnt); entries past miss_cnt
    are padding the refresh never reads."""
    order = torch.argsort(stay_mask.to(torch.int32), dim=-1, stable=True)
    miss_chunk = torch.gather(slot_ids, -1, order).to(torch.int32)
    miss_cnt = (~stay_mask).sum(-1).to(torch.int32)
    return miss_chunk, order.to(torch.int32), miss_cnt

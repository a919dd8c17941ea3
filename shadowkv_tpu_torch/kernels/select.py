"""Landmark selection of the decode step: the kernel and its plain version.

The JAX package selects with plain jnp (``shadowkv_tpu/core/selection.py``:
``score_and_select`` then ``assign_slots_stable``), with no Pallas kernel;
``select_slots_plain`` is that composition in PyTorch (the port's
``core/selection.py``). On the card it upcast each layer's landmark table to
f32, ran an f32 GEMM, ~25 small launches, ``torch.topk`` with its sort and an
int sort, so this kernel (``csrc/select.cu``) is the port's own: it reads each
landmark byte once in its stored dtype (bf16, or int8 times its f32 row
scale), sums in f32, finds the top S by a radix select over the probs' bits
and assigns slots from bitmaps, in one launch a layer.

Its chosen set equals the plain version's but at near-ties: sums run in
another order, and ties at the S-th prob are taken in ascending chunk id,
never an outlier (mask false) over a chunk of equal prob, where
``torch.topk`` takes ties in no stated order. Given its set, the assignment
is ``assign_slots_stable``'s, bit for bit.

``select_slots`` takes the plain version for CPU tensors and launches the
kernel, or raises, for CUDA ones. The kernel serves bf16 queries, bf16 or
int8 landmarks, head_dims that are a multiple of 16 up to 128, any G * Q and
any C; it allocates nothing itself: the wrapper allocates the outputs and,
where a range's scores do not fit in shared memory (``plan``), their scratch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from shadowkv_tpu_torch.core.selection import (
    SlotAssignment,
    assign_slots_stable,
    score_and_select,
)
from shadowkv_tpu_torch.kernels import build


def select_slots_plain(
    q_grouped: torch.Tensor,
    landmarks: torch.Tensor,
    landmark_mask: torch.Tensor,
    prev_ids: torch.Tensor,
    select_sets: int,
    landmark_scale: torch.Tensor | None = None,
    hysteresis: float = 0.0,
    forced_ids: torch.Tensor | None = None,
) -> SlotAssignment:
    """``score_and_select`` (hysteresis on ``prev_ids``), then ``forced_ids``
    ([S] or [B, K, S]) in place of the chosen set if given, then
    ``assign_slots_stable``."""
    new_ids = score_and_select(
        q_grouped, landmarks, landmark_mask, select_sets,
        landmark_scale=landmark_scale,
        resident_ids=prev_ids if hysteresis else None,
        hysteresis=hysteresis,
    )
    if forced_ids is not None:
        new_ids = forced_ids.expand_as(new_ids)
    return assign_slots_stable(prev_ids, new_ids)


TILE = 64  # landmark rows of a ring stage
MAX_CLUSTER = 8  # the portable cluster size
MIN_TILES = 4  # no CTA range shorter than this
SCORE_PAD = 4  # floats past a score row (banks)
BINS = 256  # radix histogram bins (8-bit digits)
MISC_INTS = 64


class Plan(NamedTuple):
    """A launch of the kernel: N CTAs per cluster (one (batch row, KV
    head)), the chunks of a CTA's range (a multiple of TILE), the floats of
    a score row, the words of a bitmap over C, the dynamic shared memory,
    the byte offsets of its regions, and the f32 scratch for the scores (0:
    they stay in shared memory)."""

    cluster: int
    per: int
    sc_stride: int
    words: int
    smem_bytes: int
    off_q: int
    off_mask: int
    off_scale: int
    off_prev: int
    off_pbm: int
    off_nbm: int
    off_hist: int
    off_stats: int
    off_misc: int
    off_rw: int
    off_slots: int
    off_sc: int
    scratch_floats: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def device_limits() -> tuple[int, int]:
    """(SM count, opt-in shared memory a block) of the current card."""
    out = (ctypes.c_int * 2)()
    build.check(build.library().shadowkv_select_device(out), "select device")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def plan(batch: int, kv_heads: int, rows: int, chunks: int, select_sets: int,
         head_dim: int, int8: bool, sms: int | None = None,
         smem_max: int | None = None) -> Plan:
    """The kernel's launch for these shapes: ``rows`` = G * Q query rows per
    (batch row, KV head), ``chunks`` landmark rows. ``sms`` and ``smem_max``
    default to the current card's."""
    if sms is None or smem_max is None:
        sms, smem_max = device_limits()
    rows_pad = _cdiv(rows, 8) * 8
    pairs = batch * kv_heads
    cluster = max(1, min(MAX_CLUSTER, sms // pairs,
                         _cdiv(chunks, TILE) // MIN_TILES))
    per = _cdiv(_cdiv(chunks, cluster), TILE) * TILE
    words = _cdiv(chunks, 32)
    words4 = _cdiv(words, 4) * 4
    esz, stages = (1, 6) if int8 else (2, 4)
    off = stages * TILE * (head_dim * esz + 16)  # the ring
    offs = []
    for nbytes in (rows_pad * (2 * head_dim + 16),  # q rows
                   per, 4 * per if int8 else 0,  # mask bytes, row scales
                   4 * select_sets,  # the previous ids
                   4 * words4, 4 * words4,  # previous / new bitmaps
                   4 * 3 * BINS,  # two histograms and the cluster's
                   2 * 8 * rows_pad,  # (max, sum) per row: the CTA's, global
                   4 * MISC_INTS,
                   4 * 3 * (per // 32),  # range words: above T, at T, scan
                   4 * (2 * select_sets + words4)):  # the assignment's scans
        offs.append(off)
        off += _cdiv(nbytes, 16) * 16
    sc_stride = per + SCORE_PAD
    sc_bytes = 4 * rows_pad * sc_stride
    if off + sc_bytes <= smem_max:
        smem, scratch = off + sc_bytes, 0
    else:
        smem, scratch = off, cluster * pairs * rows_pad * sc_stride
    if smem > smem_max:
        raise ValueError(f"select kernel: {smem} bytes of shared memory at "
                         f"C {chunks}, S {select_sets}, {rows} rows exceed "
                         f"{smem_max}")
    return Plan(cluster, per, sc_stride, words, smem, *offs, off, scratch)


def _check_cuda_args(q, landmarks, landmark_mask, prev_ids, select_sets,
                     landmark_scale, forced_ids) -> None:
    dev = q.device
    if q.dtype != torch.bfloat16 or landmarks.dtype not in (torch.bfloat16,
                                                            torch.int8):
        raise ValueError("select_slots kernel: q must be bf16 and the "
                         "landmarks bf16 or int8")
    if q.dim() != 5 or landmarks.dim() != 4:
        raise ValueError(f"select_slots: q [B, K, G, Q, Dh] and landmarks "
                         f"[B, K, C, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(landmarks.shape)}")
    b, kh, _, _, dh = q.shape
    c = landmarks.shape[2]
    if tuple(landmarks.shape) != (b, kh, c, dh):
        raise ValueError("select_slots: q and the landmarks disagree")
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"select_slots kernel serves head_dims that are a "
                         f"multiple of 16 up to 128, got {dh}")
    if not 1 <= select_sets <= c:
        raise ValueError(f"select_slots: select_sets {select_sets} not in "
                         f"[1, C {c}]")
    if (landmark_scale is not None) != (landmarks.dtype == torch.int8):
        raise ValueError("select_slots kernel: int8 landmarks take a "
                         "landmark_scale, bf16 ones none")
    if c % 4:
        raise ValueError(f"select_slots kernel serves C a multiple of 4 (the "
                         f"port's C is one of 8), got {c}")
    want = [(landmarks, None, "landmarks"),
            (landmark_mask, torch.bool, "landmark_mask"),
            (prev_ids, torch.int32, "prev_ids")]
    if landmark_scale is not None:
        want.append((landmark_scale, torch.float32, "landmark_scale"))
    if forced_ids is not None:
        want.append((forced_ids, torch.int32, "forced_ids"))
    for t, dtype, name in want:
        if t.device != dev:
            raise ValueError(f"select_slots: {name} on another device")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"select_slots: {name} must be {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"select_slots kernel: {name} must be "
                             "contiguous")
    for t, shape in ((landmark_mask, (b, kh, c)),
                     (prev_ids, (b, kh, select_sets)),
                     (landmark_scale, (b, kh, c))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"select_slots: expected {shape}, got "
                             f"{tuple(t.shape)}")
    if forced_ids is not None and tuple(forced_ids.shape) not in (
            (select_sets,), (b, kh, select_sets)):
        raise ValueError("select_slots: forced_ids must be [S] or [B, K, S]")
    if q.stride(4) != 1 or any(s % 8 for s in q.stride()[:4]) \
            or q.data_ptr() % 16 or landmarks.data_ptr() % 16 \
            or landmark_mask.data_ptr() % 4 or (
                landmark_scale is not None and landmark_scale.data_ptr() % 16):
        raise ValueError("select_slots kernel: q rows, the landmarks and "
                         "their scales must start on 16-byte boundaries, "
                         "the mask on a 4-byte one")


def select_slots(
    q_grouped: torch.Tensor,  # [B, K, G, Q, Dh]
    landmarks: torch.Tensor,  # [B, K, C, Dh] bf16 | int8
    landmark_mask: torch.Tensor,  # [B, K, C] bool
    prev_ids: torch.Tensor,  # [B, K, S] int32, the slots' chunk ids
    select_sets: int,
    landmark_scale: torch.Tensor | None = None,  # [B, K, C] f32 (int8)
    hysteresis: float = 0.0,
    forced_ids: torch.Tensor | None = None,  # [S] | [B, K, S] int32
) -> SlotAssignment:
    """Landmark selection and the slot-stable assignment
    (``select_slots_plain``'s function): CPU tensors take the plain version,
    CUDA ones the kernel on the current stream."""
    if not q_grouped.is_cuda:
        return select_slots_plain(q_grouped, landmarks, landmark_mask,
                                  prev_ids, select_sets, landmark_scale,
                                  hysteresis, forced_ids)
    _check_cuda_args(q_grouped, landmarks, landmark_mask, prev_ids,
                     select_sets, landmark_scale, forced_ids)
    b, kh, g, qn, dh = q_grouped.shape
    c = landmarks.shape[2]
    int8 = landmarks.dtype == torch.int8
    p = plan(b, kh, g * qn, c, select_sets, dh, int8)
    dev = q_grouped.device
    slot_ids = torch.empty(b, kh, select_sets, dtype=torch.int32, device=dev)
    stay = torch.empty(b, kh, select_sets, dtype=torch.bool, device=dev)
    stay_count = torch.empty(b, kh, dtype=torch.int32, device=dev)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32, device=dev)
               if p.scratch_floats else None)
    # 1 + hysteresis rounded in f32, as the plain version's factor
    hyst = (float(torch.tensor(hysteresis, dtype=torch.float32) + 1.0)
            if hysteresis else 0.0)
    layout = (ctypes.c_int * 17)(*p[:17])
    select_slots.launches += 1
    rc = build.library().shadowkv_select(
        q_grouped.data_ptr(), landmarks.data_ptr(),
        None if landmark_scale is None else landmark_scale.data_ptr(),
        landmark_mask.data_ptr(), prev_ids.data_ptr(),
        None if forced_ids is None else forced_ids.data_ptr(),
        slot_ids.data_ptr(), stay.data_ptr(), stay_count.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        *q_grouped.stride()[:4],
        0 if forced_ids is None or forced_ids.dim() == 1 else select_sets,
        b, kh, g, qn, c, select_sets, dh, int(int8),
        ctypes.cast(layout, ctypes.c_void_p), hyst,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "select_slots")
    return SlotAssignment(slot_ids, stay, stay_count)


select_slots.launches = 0  # kernel launches (CUDA path only)

"""The tile plan of the prefill attention kernel (B dense causal, C sink +
sliding window) against the masks it serves.

``kernels/prefill_attention.py::prefill_tile_plan`` says, per 128-row
query block, which 128-key tiles the CUDA kernel visits and which of those
need a per-pair mask; the kernel transcribes it. Here it is held against
the dense mask ``kv <= q & (kv < sink | q - kv < window)`` (every active
pair lies in a visited tile, every full tile holds only active pairs,
every visited tile holds at least one) and against the block classes the
JAX package's splash kernel derives from the same mask. Exact integer
checks: no tolerance."""

from __future__ import annotations

import numpy as np
import pytest
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_mask as splash_mask,
)
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_mask_info as splash_info,
)

from shadowkv_tpu_torch.kernels.prefill_attention import (
    TILE,
    prefill_tile_plan,
)

# (window, sink): None is B (causal); the rest are C with windows and sinks
# on and off the 128-key tile edges, empty, and wider than the sequence.
MASKS = [
    None,
    (128, 128), (256, 0), (100, 0), (64, 16), (1, 70), (0, 64), (300, 129),
    (1024, 64), (1000, 1000), (0, 0),
]


def _dense(s: int, mask) -> np.ndarray:
    q = np.arange(s)[:, None]
    kv = np.arange(s)[None, :]
    act = kv <= q
    if mask is not None:
        window, sink = mask
        act &= (kv < sink) | (q - kv < window)
    return act


def _plan(s: int, mask):
    if mask is None:
        return prefill_tile_plan(s)
    return prefill_tile_plan(s, window=mask[0], sink=mask[1])


@pytest.mark.parametrize("mask", MASKS, ids=str)
@pytest.mark.parametrize("s", [1, 63, 72, 128, 129, 200, 4104])
def test_plan_covers_the_dense_mask(s, mask):
    act = _dense(s, mask)
    plans = _plan(s, mask)
    n_tiles = -(-s // TILE)
    assert len(plans) == n_tiles
    for qb, plan in enumerate(plans):
        rows = act[qb * TILE:(qb + 1) * TILE]
        visit = plan.full + plan.masked
        # The three classes partition the tiles.
        assert sorted(visit + plan.skipped) == list(range(n_tiles))
        for t in range(n_tiles):
            block = rows[:, t * TILE:(t + 1) * TILE]
            if t in plan.skipped:
                assert not block.any(), (qb, t)
            else:
                assert block.any(), (qb, t)  # no tile visited for nothing
            if t in plan.full:
                # Full: every pair of the block's rows below s and of the
                # tile's 128 keys (none past s) is active.
                assert block.shape[1] == TILE and block.all(), (qb, t)


# splash refuses a mask with no active pair, so (0, 0) is left out there.
@pytest.mark.parametrize("mask", [m for m in MASKS if m != (0, 0)], ids=str)
@pytest.mark.parametrize("s", [128, 256, 1024])
def test_plan_matches_the_splash_block_classes(s, mask):
    """At a sequence of whole tiles, the plan's skipped / masked / full
    classes are the splash kernel's empty / partial / full blocks of the
    same mask at 128 x 128 blocks."""
    info, _ = splash_info.process_mask(
        splash_mask.MultiHeadMask([splash_mask.NumpyMask(_dense(s, mask))]),
        (TILE, TILE),
    )
    # splash keeps, per query block, only its non-empty blocks: entry j is
    # of class block_mask[qb, j] (0 pads) at KV block data_next[qb, j].
    cls = np.asarray(info.block_mask)[0]
    kv_block = np.asarray(info.data_next)[0]
    n = s // TILE
    want = np.zeros((n, n), dtype=np.int64)
    for qb, j in zip(*np.nonzero(cls)):
        want[qb, kv_block[qb, j]] = cls[qb, j]
    got = np.zeros_like(want)
    for qb, plan in enumerate(_plan(s, mask)):
        got[qb, plan.masked] = 1
        got[qb, plan.full] = 2
    np.testing.assert_array_equal(got, want)


def test_causal_plan_masks_the_diagonal_only():
    """B at whole tiles: below the diagonal every tile is full, the
    diagonal tile is the one masked tile, and nothing above is visited."""
    for qb, plan in enumerate(prefill_tile_plan(32768)):
        assert plan.full == list(range(qb))
        assert plan.masked == [qb]


def test_stream_plan_at_the_main_path_shape():
    """C at S 32768, window 8192, sink 1024 (the JAX defaults): the eight
    sink tiles, then the window's tiles; only the window's first tile and
    the diagonal are masked once the window has moved past the sink."""
    plans = prefill_tile_plan(32768, window=8192, sink=1024)
    visited = sum(len(p.full) + len(p.masked) for p in plans)
    masked = sum(len(p.masked) for p in plans)
    assert visited < 0.5 * 256 * 257 / 2
    last = plans[-1]
    assert last.full == list(range(8)) + list(range(256 - 64, 255))
    assert last.masked == [256 - 65, 255]
    # Two per block, but one in the first 72 blocks, where the window's
    # first tile still lies inside the sink (keys below 1024).
    assert masked == 2 * 256 - 72

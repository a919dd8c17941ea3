"""The tile plans of the sparse prefill kernels F (vertical + slash tiles)
and G (block walk) against the masks they serve.

``kernels/vs_tile.py::vs_tile_plan`` and ``kernels/vs_sparse.py::
vs_walk_plan`` say, per row and 128-row query block, which 128-key tiles
the CUDA kernels visit and which of those need a per-pair mask; the kernels
transcribe them. Here they are held against the dense token masks of the
kernels' functions (``vs_tile.tile_masks``, ``minference.walk_masks``):
a skipped tile holds no active pair (so every active pair lies in a
visited tile) and a full tile only active pairs. F's split is checked too:
the pairs its diagonal phase counts (band on) and those its vertical phase
counts (a vertical whose band is off) add up to ``tile_masks`` with each
pair counted exactly once. Flags and verticals come from a numpy seed;
exact integer checks, no tolerance."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.core.minference import meta_from_flags, walk_masks
from shadowkv_tpu_torch.kernels import prefill_attention, vs_sparse, vs_tile

T = vs_tile.TILE
BH = 3

# (block, S_pad, seq_len): ragged seq_len, S_pad a multiple of 64 but not
# of 128 (448, 576), and a block that is a multiple of 64 but not a power
# of two (192). G needs S_pad to be a multiple of the block.
SHAPES = [
    (64, 448, 448), (64, 448, 391), (64, 576, 519),
    (128, 512, 459), (128, 640, 640), (128, 384, 300),
    (192, 576, 500), (192, 768, 768),
    (256, 768, 700), (256, 512, 512), (256, 1024, 777),
]
DENSITIES = [0.3, 0.9]


def _flags(block, s_pad, p, seed):
    """(column, diagonal) flags [BH, ceil(S_pad / block)]; the main
    diagonal is not forced on, so rows without active pairs occur."""
    rng = np.random.RandomState(seed)
    n = -(-s_pad // block)
    flags = (rng.rand(2, BH, n) < p).astype(np.int32)
    return torch.from_numpy(flags[0]), torch.from_numpy(flags[1])


def _verticals(s_pad, seed):
    """[BH, 300] vertical ids with duplicates, ids past the sequence and
    pads: some vertical tiles are full of real positions."""
    rng = np.random.RandomState(seed + 1)
    v_idx = rng.randint(0, s_pad, (BH, 300)).astype(np.int32)
    v_idx[:, 100:120] = v_idx[:, :20]
    v_idx[:, -3:] = 2 * s_pad
    return torch.from_numpy(v_idx)


def _blocks(mask, seq_len, n_rows, n_cols, fill):
    """[BH, S, C] pair mask -> [BH, nQ, 128, nC, 128]: rows at or past
    seq_len set to ``fill``, columns past C (in the other rows) to False."""
    bh, s, c = mask.shape
    out = torch.zeros(bh, n_rows * T, n_cols * T, dtype=torch.bool)
    out[:, :s, :c] = mask
    out[:, seq_len:] = fill
    return out.view(bh, n_rows, T, n_cols, T)


def _check_plan(mask, seq_len, visited, full):
    """A skipped tile holds no active pair of the rows below seq_len; a
    full one only active pairs, on all 128 of its keys."""
    nq, nc = visited.shape[1:]
    any_ = _blocks(mask, seq_len, nq, nc, False).any(dim=(2, 4))
    all_ = _blocks(mask, seq_len, nq, nc, True).all(dim=(2, 4))
    assert not (any_ & ~visited).any(), "an active pair in a skipped tile"
    assert not (full & ~all_).any(), "an inactive pair in a full tile"
    assert not (full & ~visited).any()


def _band(diag, block, s_pad, seq_len):
    """[BH, S, S]: the pairs F's diagonal phase counts."""
    pos = torch.arange(s_pad)
    band = (pos[:, None] - pos[None, :]).clamp(min=0) // block
    causal = (pos[None, :] <= pos[:, None]) & (pos[None, :] < seq_len)
    return causal[None] & (diag > 0)[:, band]


def _vertical_pairs(vpos, diag, block, s_pad, seq_len):
    """[BH, S, NV]: the (row, vertical entry) pairs F's vertical phase
    counts: the vertical is causal, below seq_len, and its band is off."""
    q = torch.arange(s_pad)[None, :, None]
    p = vpos.long()[:, None, :]
    band = ((q - p).clamp(min=0) // block).clamp(max=diag.shape[1] - 1)
    off = ~torch.gather((diag > 0)[:, None, :].expand(-1, s_pad, -1), 2,
                        band.expand(-1, s_pad, -1))
    return (p <= q) & (p < seq_len) & off


def _cases():
    return [(b, s, n, p) for b, s, n in SHAPES for p in DENSITIES]


@pytest.mark.parametrize("block, s_pad, seq_len, p", _cases())
def test_tile_plan_covers_the_dense_masks(block, s_pad, seq_len, p):
    _, diag = _flags(block, s_pad, p, seed=block + s_pad)
    vpos = vs_tile.vertical_positions(_verticals(s_pad, seed=block),
                                      s_pad, seq_len)
    plan = vs_tile.vs_tile_plan(vpos, diag, block, s_pad, seq_len)
    nq = -(-s_pad // T)
    assert plan.full.shape == plan.masked.shape == (BH, nq, nq)
    assert plan.vertical.shape == (BH, nq, vpos.shape[1] // T)
    assert not (plan.full & plan.masked).any()
    _check_plan(_band(diag, block, s_pad, seq_len), seq_len,
                plan.full | plan.masked, plan.full)
    vert = _vertical_pairs(vpos, diag, block, s_pad, seq_len)
    _check_plan(vert, seq_len, plan.vertical,
                torch.zeros_like(plan.vertical))


@pytest.mark.parametrize("block, s_pad, seq_len, p", _cases())
def test_tile_split_counts_each_pair_once(block, s_pad, seq_len, p):
    """Diagonal phase (band on) plus vertical phase (vertical, band off),
    scattered to token positions, equals tile_masks pair for pair: every
    active pair counted once, no inactive one."""
    _, diag = _flags(block, s_pad, p, seed=block + s_pad)
    v_idx = _verticals(s_pad, seed=block)
    vpos = vs_tile.vertical_positions(v_idx, s_pad, seq_len)
    counts = _band(diag, block, s_pad, seq_len).int()
    vert = _vertical_pairs(vpos, diag, block, s_pad, seq_len).int()
    counts.scatter_add_(2, vpos.long().clamp(max=s_pad - 1)[:, None, :]
                        .expand(-1, s_pad, -1), vert)
    (_, want), = vs_tile.tile_masks(v_idx, diag, block, s_pad, seq_len,
                                    s_pad)
    assert torch.equal(counts[:, :seq_len], want.int()[:, :seq_len])


@pytest.mark.parametrize("block, s_pad, seq_len, p", _cases())
def test_walk_plan_covers_the_dense_mask(block, s_pad, seq_len, p):
    col, diag = _flags(block, s_pad, p, seed=block + s_pad)
    plan = vs_sparse.vs_walk_plan(col, diag, block, s_pad, seq_len)
    nq = -(-s_pad // T)
    assert plan.full.shape == plan.masked.shape == (BH, nq, nq)
    assert not (plan.full & plan.masked).any()
    (_, mask), = walk_masks(meta_from_flags(col, diag), block, s_pad, seq_len,
                            s_pad)
    _check_plan(mask, seq_len, plan.full | plan.masked, plan.full)


def _causal_classes():
    """B's plan at S 32768: (full, masked) as [nQ, nT] flags."""
    plans = prefill_attention.prefill_tile_plan(32768)
    full = torch.zeros(len(plans), len(plans), dtype=torch.bool)
    masked = torch.zeros_like(full)
    for qb, p in enumerate(plans):
        full[qb, p.full] = True
        masked[qb, p.masked] = True
    return full, masked


def test_plans_with_every_block_on_are_the_causal_plan():
    """At the main path's S 32768, block 128, with every band, column and
    diagonal on (the near-dense estimated flags of synthetic weights): F
    and G visit the causal tiles, full below the diagonal, masked on it,
    as kernel B does, and F skips every vertical tile (its pairs all lie
    on bands that are on)."""
    s, block = 32768, 128
    ones = torch.ones(1, s // block, dtype=torch.int32)
    full, masked = _causal_classes()
    vpos = vs_tile.vertical_positions(
        torch.arange(0, s, 33, dtype=torch.int32)[None, :1000], s, s)
    f = vs_tile.vs_tile_plan(vpos, ones, block, s, s)
    g = vs_sparse.vs_walk_plan(ones, ones, block, s, s)
    for plan in (f, g):
        assert torch.equal(plan.full[0], full)
        assert torch.equal(plan.masked[0], masked)
    assert not f.vertical.any()


def test_tile_plan_skips_the_bands_that_are_off():
    """F with only the main band on and no verticals visits the diagonal
    tile and the one before it (whose pairs reach distances below 128) and
    masks both."""
    s, block = 1024, 128
    diag = torch.zeros(1, s // block, dtype=torch.int32)
    diag[0, 0] = 1
    vpos = vs_tile.vertical_positions(
        torch.full((1, 8), 2 * s, dtype=torch.int32), s, s)
    plan = vs_tile.vs_tile_plan(vpos, diag, block, s, s)
    assert not plan.full.any() and not plan.vertical.any()
    for qb in range(s // T):
        assert plan.masked[0, qb].nonzero().flatten().tolist() == \
            list(range(max(0, qb - 1), qb + 1))

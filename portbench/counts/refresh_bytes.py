"""The least bytes and operations of one refresh launch (kernel A, one
layer of one step) from its exact misses: each missed chunk's V rows (and
int8 scales) read once per (row, head), its U rows (and scales) once per
row however many heads missed it, SV once per (row, head) with a miss, and
the rebuilt K and the V rows written once in bf16.

``prev`` and ``cur`` are the selected chunk ids [B, K, S] of the step
before and of this step (numpy ints). Returns (device bytes, host bytes,
operations): with V on the host its rows cross the link, its scales do
not."""

from __future__ import annotations

import numpy as np


def refresh_bytes(prev: np.ndarray, cur: np.ndarray, *, chunk: int,
                  rank: int, head_dim: int, quant: bool,
                  v_on_host: bool) -> tuple[int, int, int]:
    b, kh, _ = cur.shape
    store_b = 1 if quant else 2
    miss_rows = 0
    heads_with_miss = 0
    u_chunks = 0
    for bi in range(b):
        row_missed = set()
        for ki in range(kh):
            missed = np.setdiff1d(cur[bi, ki], prev[bi, ki],
                                  assume_unique=True)
            miss_rows += missed.size * chunk
            heads_with_miss += int(missed.size > 0)
            row_missed.update(missed.tolist())
        u_chunks += len(row_missed)
    u_rows = u_chunks * chunk
    v_bytes = miss_rows * head_dim * store_b
    dev = u_rows * rank * store_b + heads_with_miss * rank * head_dim * 2 \
        + miss_rows * head_dim * 2 * 2
    if quant:
        dev += (u_rows + miss_rows) * 2
    host = 0
    if v_on_host:
        host = v_bytes
    else:
        dev += v_bytes
    ops = 2 * miss_rows * rank * head_dim
    return dev, host, ops

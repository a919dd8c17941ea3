"""The operation and byte counters against values worked by hand at the
shapes of glm4-9b.decode-32k-b8 (GLM-4-9B: 40 layers, d 4096, 32 / 4
heads of 128, ffn 13696, vocab 151552; prompt 32768, chunk 8, 4 local
chunks, 48 outliers, budget 2048, rank 160)."""

import json

import numpy as np
import pytest

from portbench.counts.attn_b_flops import causal_attention_flops
from portbench.counts.decode_flops import decode_step_flops
from portbench.counts.matmul_params import (head_matmul_params,
                                            layer_matmul_params)
from portbench.counts.prefill_flops import prefill_flops
from portbench.counts.refresh_bytes import refresh_bytes
from portbench.layout import layout
from portbench.spec import PKG

GLM = json.loads((PKG / "configs" / "glm4-9b-chat-1m.json").read_text())
MD, CACHE = GLM["model"], GLM["cache"]


def test_matmul_params():
    # qkv 4096 x (4096 + 2 * 512), o 4096 x 4096, gate/up 4096 x 27392,
    # down 13696 x 4096
    assert layer_matmul_params(MD) == 20971520 + 16777216 + 112197632 \
        + 56098816 == 206045184
    assert head_matmul_params(MD) == 620756992


def test_layout_at_32k():
    lay = layout(CACHE, 32768)
    # 4096 chunks - 4 local = 4092, rounded down to 4088; 64 local rows
    assert (lay.chunks, lay.local_rows, lay.sets) == (4088, 64, 256)
    assert lay.static_rows == 64 + 48 * 8


@pytest.mark.parametrize("depth", [0, 127])
def test_decode_step_flops(depth):
    lay = layout(CACHE, 32768)
    attended = 448 + 2048 + depth + 1
    mm = 2 * (40 * 206045184 + 620756992)  # 17,725,128,704
    attn = 4 * 32 * 128 * attended * 40
    assert decode_step_flops(MD, lay, depth) == mm + attn
    if depth == 0:
        assert mm + attn == 17725128704 + 1636433920


def test_prefill_flops():
    s = 32768
    pairs = s * (s + 1) // 2  # 536,887,296 causal pairs
    assert causal_attention_flops(MD, s) == 4 * pairs * 128 * 32 \
        == 8796361457664
    assert prefill_flops(MD, s) == 2 * 40 * 206045184 * s + 2 * 620756992 \
        + 40 * 8796361457664


def test_refresh_bytes_bf16_on_card():
    prev = np.array([[[0, 1, 2], [0, 1, 2]]])
    cur = np.array([[[0, 1, 5], [3, 1, 2]]])  # one miss in each head
    dev, host, ops = refresh_bytes(prev, cur, chunk=8, rank=160, head_dim=128,
                                   quant=False, v_on_host=False)
    # U: 2 distinct chunks x 8 rows x 160 x 2 B; SV: 2 heads x 160 x 128 x
    # 2 B; K and V written: 16 rows x 128 x 2 B x 2; V read: 16 x 128 x 2 B
    assert dev == 5120 + 81920 + 8192 + 4096 == 99328
    assert host == 0
    assert ops == 2 * 16 * 160 * 128 == 655360


def test_refresh_bytes_int8_on_host():
    prev = np.array([[[0, 1, 2], [0, 1, 2]]])
    cur = np.array([[[0, 1, 5], [5, 1, 2]]])  # both heads miss chunk 5
    dev, host, _ = refresh_bytes(prev, cur, chunk=8, rank=160, head_dim=128,
                                 quant=True, v_on_host=True)
    # U rows read once for the row: 8 x 160 x 1 B + 8 scales x 2 B; V's 16
    # rows' scales 16 x 2 B; SV 2 x 160 x 128 x 2 B; writes 16 x 128 x 4 B
    assert dev == 1280 + 16 + 32 + 81920 + 8192
    assert host == 16 * 128  # V rows, int8, over the link


def test_readers_by_hand():
    """slot_hit_rate and refresh_roofline_pct on a hand-made trace: one
    step, one layer, one row, one head, ids 0-3 then 3, 4, 1, 9."""
    from portbench.metrics import refresh_roofline_pct, slot_hit_rate
    from portbench.trace import TraceData

    ids = np.array([[[[[0, 1, 2, 3]]]], [[[[3, 4, 1, 9]]]]])
    # 10 us of kernel A in a 100 us window
    trace = TraceData(span=(0.0, 100.0),
                      device=[("void refresh_kernel<false, 16>(RefreshArgs)",
                               10.0, 20.0)], host=[])
    obs = {"depths": [0], "ids": ids, "trace": trace, "model": MD,
           "cache": CACHE, "v_on_host": False}
    assert slot_hit_rate.read(obs) == 0.5
    dev, _, _ = refresh_bytes(ids[0, 0], ids[1, 0], chunk=8, rank=160,
                              head_dim=128, quant=False, v_on_host=False)
    want = 100 * (dev / 3.35e12) / 10e-6
    assert refresh_roofline_pct.read(obs) == pytest.approx(want)
    assert trace.busy_s == pytest.approx(10e-6)

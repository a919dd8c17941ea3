"""The plain reference against the port on the CPU at toy GLM-style
(interleaved partial RoPE, qkv bias, stores in the model dtype) and
Yi-style (neox RoPE, int8 stores, V on the host) sizes: whole runs of the
harness, float32 weights, so the port and the reference agree to rounding
and any disagreement is a fault of one of them."""

import pytest
import torch

from portbench import harness
from portbench.reference import model as m
from portbench.tests import toy

SEED = 2 ** 33 + 17  # more than 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_root(tmp_path_factory.mktemp("toy"))


def run(root, cell, trace=False, control=True, seed=SEED):
    return harness.execute(cell, seed, 0.3, trace, torch.device("cpu"), 0.0,
                           root, control=control)


@pytest.mark.parametrize("cell", ["toy-glm.decode", "toy-yi.decode"])
def test_decode_matches_reference(root, cell):
    res = run(root, cell)
    assert res["correct"]
    # every greedy token of the drawn row is the reference's best
    assert res["checks"]["gap"]["value"] <= 1e-4
    # argmaxes agree but for exact ties (int8 rounding of equal values)
    assert res["notes"]["agree"] >= 0.9
    assert res["notes"]["judged_tokens"] >= 17
    # the fp8 control picks other tokens, and is not correct
    assert res["notes"]["control"]["gap"] > 1e-2
    assert res["notes"]["control_correct"] is False


@pytest.mark.parametrize("cell", ["toy-glm.prefill", "toy-yi.prefill"])
def test_prefill_matches_reference(root, cell):
    res = run(root, cell)
    assert res["correct"]
    assert set(res["checks"]) == set(toy.PREFILL_NUMBERS)
    for k in toy.PREFILL_NUMBERS:
        # an int8 code at a rounding boundary flips by one step (1/127 of
        # its row's largest value) on float32 rounding noise
        tol = 1e-3 if k == "store_err" and cell == "toy-yi.prefill" else 1e-4
        assert abs(res["checks"][k]["value"]) <= tol, k
    for k in ("logit_err", "lowrank_excess", "landmark_err", "store_err",
              "buffer_err"):
        assert res["notes"]["control"][k] > 1e-3, k


def test_rope_styles_by_hand():
    """GLM rotates (even, odd) pairs of the first rot lanes and passes the
    rest; neox rotates lane i with lane i + Dh/2."""
    model = {"rope_theta": 10000.0, "head_dim": 8, "rope_partial_dim": 4}
    x = torch.arange(8.0).view(1, 1, 8)
    cos, sin = m.rope_tables(model, torch.tensor([1]))
    y = m.apply_rope(x, cos, sin, "glm")[0, 0]
    a0, a1 = 1.0, 10000.0 ** -0.5
    c0, s0 = torch.cos(torch.tensor(a0)), torch.sin(torch.tensor(a0))
    assert torch.allclose(y[0:2], torch.stack([0 * c0 - 1 * s0,
                                               1 * c0 + 0 * s0]))
    c1, s1 = torch.cos(torch.tensor(a1)), torch.sin(torch.tensor(a1))
    assert torch.allclose(y[2:4], torch.stack([2 * c1 - 3 * s1,
                                               3 * c1 + 2 * s1]))
    assert torch.equal(y[4:], x[0, 0, 4:])
    model = {"rope_theta": 10000.0, "head_dim": 4}
    cos, sin = m.rope_tables(model, torch.tensor([1]))
    y = m.apply_rope(torch.arange(4.0).view(1, 1, 4), cos, sin, "neox")[0, 0]
    assert torch.allclose(y[0], 0 * c0 - 2 * s0)
    assert torch.allclose(y[2], 2 * c0 + 0 * s0)


def test_causal_attention_blocks_agree():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(40, 4, 8, generator=g)
    k = torch.randn(40, 2, 8, generator=g)
    v = torch.randn(40, 2, 8, generator=g)
    a = m.causal_attention(q, k, v, block=7)
    b = m.causal_attention(q, k, v, block=64)
    assert torch.allclose(a, b, atol=1e-6)
    # row 0 attends only itself
    assert torch.allclose(a[0, :2], v[0, 0].expand(2, 8), atol=1e-6)


@pytest.mark.parametrize("cell", ["toy-glm.decode", "toy-glm.prefill"])
def test_traced_run_reads_its_metrics(root, cell):
    res = run(root, cell, trace=True, control=False)
    assert res["correct"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert res["device"]["window_s"] > 0
    for k in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][k]) <= 10
    if cell.endswith("decode"):
        assert 0.0 <= res["metrics"]["slot_hit_rate"]["value"] <= 1.0
    # CPU runs have no device trace: device metrics are left out
    assert "decode_idle_pct" not in res["metrics"]

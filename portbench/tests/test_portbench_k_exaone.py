"""The ``hybrid_rounds`` cells: a toy K-EXAONE (a window-8 sliding layer
period and a NoPE global layer, QK-norm, post-norm, MoE layers of 16
experts with 4 held) through the harness on the CPU, sound and with the
faults of ``portbench/faults_hybrid.py`` planted; on the card, the cell at
its own size: the fp8 control and each planted fault fail one of its
limits while the program passes them all."""

import copy
import json
import time

import pytest
import torch

from portbench import faults_hybrid, harness
from portbench.spec import ROOT

SEED = 3 * 2 ** 31 + 7
CELL = "k-exaone.decode-32k-b8"
TOY_CELL = "toy-k-exaone.decode"
NUMBERS = ("gap", "select_regret", "outlier_gap", "route_regret", "ring_err")
TYPES = ["sliding_attention"] * 4 + ["full_attention"]
TOY = {
    "name": "toy-k-exaone", "source": "test", "first_k_dense_replace": 1,
    "head_dim": 32, "hidden_act": "silu", "hidden_size": 128,
    "intermediate_size": 256, "layer_types": TYPES,
    "max_position_embeddings": 4096,
    "mlp_layer_types": ["dense"] + ["sparse"] * 4, "model_type": "exaone_moe",
    "moe_intermediate_size": 32, "n_group": 1, "norm_topk_prob": True,
    "num_attention_heads": 4, "num_experts": 4, "num_experts_per_tok": 4,
    "num_hidden_layers": 5, "num_key_value_heads": 2,
    "num_shared_experts": 1, "rms_norm_eps": 1e-5,
    "rope_parameters": {"rope_theta": 10000, "rope_type": "default"},
    "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
    "sliding_window": 8, "tie_word_embeddings": False, "topk_group": 1,
    "vocab_size": 512, "num_experts_published": 16,
    "held_experts": [0, 1, 2, 3],
    "model": {"dtype": "float32"},
    "cache": {"mode": "shadow", "sparse_budget": 64, "rank": 16,
              "chunk_size": 8, "local_chunks": 4, "outlier_chunks": 2,
              "gen_capacity": 16, "kv_quant": "none"},
    "runtime": {"use_pallas": True, "prefill_sub_batch": 2},
    "init": {"std": 0.1, "router_std": 0.088, "bias_std": 0.02},
    "reduced": ["num_experts"],
}
ROUNDS = {"kind": "hybrid_rounds", "batch": 4, "prompt_len": 256,
          "question_len": 4, "answer_len": 12}
HYBRID_METRICS = ("moe_ms_per_step", "moe_roofline_pct", "swa_ms_per_step",
                  "hybrid_decode_mfu")


def toy_root(root, limit: float):
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    (root / "portbench/configs/toy-k-exaone.json").write_text(json.dumps(TOY))
    (root / "portbench/traffic/toy-hybrid.json").write_text(json.dumps(ROUNDS))
    (root / f"portbench/limits/{TOY_CELL}.json").write_text(
        json.dumps(dict.fromkeys(NUMBERS, limit)))
    bench = copy.deepcopy(real)
    bench["configs"] = [{"name": "toy-k-exaone", "source": "test",
                         "file": "portbench/configs/toy-k-exaone.json",
                         "reduced": ["num_experts"], "why": "toy"}]
    bench["workloads"] = [{"name": TOY_CELL, "config": "toy-k-exaone",
                           "traffic": "toy-hybrid", "chips": 1,
                           "why": "toy"}]
    bench["end_to_end"] = [dict(m, workloads=[TOY_CELL])
                           for m in real["end_to_end"]
                           if m["name"] in ("decode_tok_s", "itl_p95_ms",
                                            "setup_s")]
    bench["per_layer"] = [dict(m, workloads=[TOY_CELL])
                          for m in real["per_layer"]
                          if m["name"] in HYBRID_METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # limits well above the sound runs' readings (float32, ~1e-6)
    return toy_root(tmp_path_factory.mktemp("toy-hybrid"), limit=1e-3)


def run(root, seed=SEED, trace=False, control=False):
    return harness.execute(TOY_CELL, seed, 0.3, trace, torch.device("cpu"),
                           0.0, root, control=control)


def test_sound_run_is_correct_and_the_control_is_not(root):
    res = run(root, control=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(NUMBERS)
    assert res["notes"]["control_correct"] is False, res["notes"]["control"]
    assert res["notes"]["agree"] == 1.0


def test_traced_run_reads_the_cpu_side(root):
    """On the CPU the trace has no device kernels: the span readers find no
    markers and the device readers nothing, so no metric is reported, and
    the run stays correct."""
    res = run(root, trace=True)
    assert res["correct"]
    assert res["metrics"] == {}


@pytest.mark.parametrize("fault", sorted(faults_hybrid.FAULTS))
def test_planted_fault_is_caught(root, fault):
    with faults_hybrid.planted(fault):
        assert run(root)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(faults_hybrid.FAULTS))
def test_planted_fault_fails_the_cell_on_the_card(card, fault):
    with faults_hybrid.planted(fault):
        res = harness.execute(CELL, 2 ** 31 + 17, 5.0, False, card,
                              time.perf_counter(), ROOT)
    assert res["correct"] is False, res["checks"]

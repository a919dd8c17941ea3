"""A benchmark root of toy cells for the CPU tests: the real package's
drivers, readers and reference over small configurations written to a
temporary directory (``BENCHMARK.json``, config, traffic and limit files),
as a later change would add a cell."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench.spec import ROOT

GLM = {
    "name": "toy-glm",
    "source": "test",
    "model": {
        "num_layers": 2, "hidden_size": 256, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 64, "intermediate_size": 384,
        "vocab_size": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "rope_style": "glm", "rope_partial_dim": 32, "qkv_bias": True,
        "max_position_embeddings": 4096, "dtype": "float32"},
    "cache": {"mode": "shadow", "sparse_budget": 64, "rank": 16,
              "chunk_size": 8, "local_chunks": 4, "outlier_chunks": 2,
              "gen_capacity": 16, "kv_quant": "none"},
    "runtime": {"use_pallas": True, "prefill_sub_batch": 2},
    "init": {"std": 0.1, "bias_std": 0.5},
    "reduced": [],
}
YI = copy.deepcopy(GLM)
YI["name"] = "toy-yi"
YI["model"].update(rope_style="neox", rope_partial_dim=None, qkv_bias=False)
YI["cache"].update(mode="shadow_offload", kv_quant="int8")
YI["init"]["bias_std"] = 0.0

ROUNDS = {"kind": "decode_rounds", "batch": 4, "prompt_len": 512,
          "question_len": 4, "answer_len": 12}
PREFILL = {"kind": "prefill_repeat", "prompt_len": 512}


def cells(root: Path, configs: dict, cells_: dict, limits: dict) -> Path:
    """Write a benchmark root: ``configs`` {name: config}, ``cells_``
    {cell: (config, traffic name, traffic)}, ``limits`` {cell: {number:
    limit}}; metrics are the real BENCHMARK.json's."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "limits").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    bench = dict(real, configs=[], workloads=[])
    for name, cfg in configs.items():
        f = f"portbench/configs/{name}.json"
        (root / f).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file": f,
                                 "reduced": [], "why": "toy"})
    for cell, (cfg, tname, traffic) in cells_.items():
        (root / "portbench" / "traffic" / f"{tname}.json").write_text(
            json.dumps(traffic))
        (root / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits[cell]))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": tname, "chips": 1,
                                   "why": "toy"})
    kinds = {c: t["kind"] for c, (_, _, t) in cells_.items()}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if m["name"] == "setup_s":
                continue
            want = ("prefill_repeat" if m["name"].startswith(("prefill",
                                                              "attn_b"))
                    else "decode_rounds")
            m["workloads"] = [c for c, k in kinds.items() if k == want]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


DECODE_NUMBERS = ("gap", "select_regret", "outlier_gap")
PREFILL_NUMBERS = ("logit_err", "lowrank_excess", "landmark_err", "store_err",
                   "buffer_err", "outlier_gap", "select_regret")


def toy_root(tmp: Path, limit: float = 1e-3) -> Path:
    return cells(
        tmp, {"toy-glm": GLM, "toy-yi": YI},
        {"toy-glm.decode": ("toy-glm", "toy-rounds", ROUNDS),
         "toy-yi.decode": ("toy-yi", "toy-rounds", ROUNDS),
         "toy-glm.prefill": ("toy-glm", "toy-prefill", PREFILL),
         "toy-yi.prefill": ("toy-yi", "toy-prefill", PREFILL)},
        {"toy-glm.decode": dict.fromkeys(DECODE_NUMBERS, limit),
         "toy-yi.decode": dict.fromkeys(DECODE_NUMBERS, limit),
         "toy-glm.prefill": dict.fromkeys(PREFILL_NUMBERS, limit),
         "toy-yi.prefill": dict.fromkeys(PREFILL_NUMBERS, limit)})

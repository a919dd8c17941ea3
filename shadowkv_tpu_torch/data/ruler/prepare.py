"""Pre-build RULER validation jsonl files (reference
data/ruler/create_dataset.sh + prepare.py, SURVEY §3.5).

The Dataset class generates tasks on the fly when no file exists
(data/dataset.py::_build_ruler); this CLI materializes the same
samples to disk so repeated eval runs (and multi-process DP shards)
share one deterministic dataset:

    python -m shadowkv_tpu_torch.data.ruler.prepare \
        --model_name meta-llama/Meta-Llama-3.1-8B-Instruct \
        --model_dir /path/to/ckpt \
        --lengths 65536,131072 \
        --tasks niah_single_1,qa_1,vt \
        [--num_samples 24] [--out data/ruler/data]

Files land at <out>/<template-family>/<len>/<task>/validation.jsonl —
exactly the path Dataset probes before falling back to generation.
"""

from __future__ import annotations

import argparse
import json
import os

from shadowkv_tpu_torch.data.ruler.generate import (
    TASK_CONFIGS,
    generate_task,
)
from shadowkv_tpu_torch.models.prompt_templates import (
    CTX_TEMPLATES,
    template_family,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_name", required=True)
    ap.add_argument("--model_dir", default=None,
                    help="local HF checkpoint dir (tokenizer source)")
    ap.add_argument(
        "--lengths", type=lambda s: [int(x) for x in s.split(",")],
        default=[131072],
    )
    ap.add_argument(
        "--tasks", type=lambda s: s.split(","),
        default=sorted(TASK_CONFIGS),
    )
    ap.add_argument("--num_samples", type=int, default=24)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="data/ruler/data")
    args = ap.parse_args()

    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        args.model_dir or args.model_name
    )
    family = template_family(args.model_name)
    template = CTX_TEMPLATES[family]
    for length in args.lengths:
        for task in args.tasks:
            rows = generate_task(
                task, tok, length, args.num_samples,
                seed=args.seed, model_template=template,
            )
            path = os.path.join(
                args.out, family, str(length), task, "validation.jsonl"
            )
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
            print(f"{path}: {len(rows)} samples")


if __name__ == "__main__":
    main()

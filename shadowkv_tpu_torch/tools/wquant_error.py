"""How far int8 weights move the logits, by model width and depth.

For llama-shaped models with synthetic N(0, 0.02) bf16 weights (head_dim
128, MLP 3.5x the width, vocab 4096), the last-token logits of one
full-attention prefill with int8 weights (``core/wquant.py``) against the
same weights in bf16: the relative RMS error and whether the argmax
agrees. One JSON line per (width, layers).

    python -m shadowkv_tpu_torch.tools.wquant_error --device cpu \\
        --shapes 512x32 1024x32 2048x8 2048x32 4096x2

The error grows with the width at a fixed depth (the synthetic weights'
gain per layer grows with it), which is what sets the bound that
``chip_smoke.py`` holds the full-width int8 run to.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.wquant import quantize_params
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import init_synthetic_params
from shadowkv_tpu_torch.models.registry import toy_config


def logit_error(width: int, layers: int, device: str, prompt: int = 256,
                seed: int = 0) -> dict:
    cfg = toy_config(dtype=torch.bfloat16, num_layers=layers,
                     hidden_size=width, num_heads=width // 128,
                     num_kv_heads=max(1, min(8, width // 256)), head_dim=128,
                     intermediate_size=width * 7 // 2, vocab_size=4096)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_synthetic_params(cfg, gen, device=device)
    ids = np.random.RandomState(seed).randint(1, cfg.vocab_size, (1, prompt))

    def logits(p):
        eng = Engine(cfg, CacheConfig(mode="full", max_length=prompt + 8),
                     RuntimeConfig(), p, device=device)
        return eng.prefill(ids)[0].float()

    a, b = logits(params), logits(quantize_params(params))
    return dict(width=width, layers=layers, device=device,
                rel_rms=float(torch.linalg.vector_norm(a - b)
                              / torch.linalg.vector_norm(a)),
                argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--shapes", nargs="+", default=["512x32", "1024x32",
                                                    "2048x8", "2048x32",
                                                    "4096x2"],
                   help="WIDTHxLAYERS")
    args = p.parse_args(argv)
    for shape in args.shapes:
        width, layers = map(int, shape.split("x"))
        print(json.dumps(logit_error(width, layers, args.device)), flush=True)


if __name__ == "__main__":
    main()

"""Write a bench-shape ``params.npz`` of synthetic weights (counterpart of
the JAX repo's ``scripts/gen_bench_npz.py``).

``checkpoints/`` is gitignored, so a fresh checkout has no snapshot. This
one has the ``sbench-1.4b-llama`` shape of ``tools/train_bench_weights.py``
with ``init_synthetic_params``' N(0, 0.02) weights from a generator
seeded 0: the synthetic-weight control of ``tools/profile_slice.py
--weights`` (trained weights come from ``tools/train_bench_weights.py``).
Runs on the card, whose generator draws the control that PERF.md reads;
``--device cpu`` draws other numbers from a CPU generator:

    python -m shadowkv_tpu_torch.tools.gen_bench_npz [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import torch

from shadowkv_tpu_torch.models.params import (
    init_synthetic_params,
    save_params_npz,
)
from shadowkv_tpu_torch.tools.train_bench_weights import bench_model_config


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="checkpoints/bench1p4b_syn")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = bench_model_config()
    params = init_synthetic_params(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "params.npz")
    save_params_npz(params, path)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()

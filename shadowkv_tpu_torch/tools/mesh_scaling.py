"""Prefill and decode of Llama-3.1-8B (synthetic bf16 weights from a seed) on
one card and on meshes of several cards, one process per card over NCCL:

    torchrun --nproc-per-node 4 shadowkv_tpu_torch/tools/mesh_scaling.py \\
        --out <file.jsonl>

Every run is ``Engine.batch_generate`` of one seeded prompt batch (greedy,
``--gen`` timed steps after 2 warmup steps) with the headline cache
(budget 2048, rank 160, chunk 16, int8 stores). In order:

- ``single``: rank 0 alone on its card (the other ranks wait), once with
  the fused refresh (the tp and dp layouts' reference) and once on the
  XLA-gather branch (the sp and pp layouts' reference);
- each layout of ``--layouts`` (``tp4``, ``dp2tp2``, ``sp4``, ``pp4``: 4
  processes) on every card: tp and dp decode through the fused refresh,
  captured with their all-reduces as one CUDA graph per rank; sp and pp on
  the XLA-gather branch (JAX's rules), pp stepping eagerly.

Rank 0 prints one JSON line per run (and appends it to ``--out``): the
layout, the card's name and power limit, ``prefill_s``, ``decode_tok_s``
(the whole batch's tokens over the timed steps), the peak GiB of every
rank, every rank's kernel launches, and against the single-device run of
the same decode path the relative error of the prefill logits (largest
difference over the largest logit) and the first timed step (after the 2
warmup steps) whose greedy tokens differ (synthetic weights have
near-ties; bf16 sums in another order, or GEMMs of fewer rows, may take
the other side).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.eval.evaluator import close_dist, init_dist
from shadowkv_tpu_torch.kernels.gather import gather_chunks
from shadowkv_tpu_torch.kernels.prefill_attention import (
    causal_prefill_offset,
    causal_prefill_splash,
)
from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import init_synthetic_params
from shadowkv_tpu_torch.models.registry import llama31_8b

LAYOUTS = {"tp4": dict(tp=4), "dp2tp2": dict(dp=2, tp=2), "sp4": dict(sp=4),
           "pp4": dict(pp=4)}
KERNELS = {"A": (sparse_refresh, "launches"),
           "B": (causal_prefill_splash, "launches"),
           "B-offset": (causal_prefill_offset, "launches"),
           "D": (gather_chunks, "launches")}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout.strip()


def _run(cfg, params, ids, axes: dict, fused: bool, gen: int) -> dict:
    """One batch_generate run on this rank; its logits, tokens and
    numbers."""
    cc = CacheConfig(mode="shadow", max_length=ids.shape[1],
                     sparse_budget=2048, rank=160, chunk_size=16,
                     kv_quant="int8", gen_capacity=256)
    rt = RuntimeConfig(use_pallas=True if fused else None, **axes)
    eng = Engine(cfg, cc, rt, params, device="cuda")
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    out, st = eng.batch_generate(ids, gen_len=gen, temperature=0.0)
    counts = {k: getattr(fn, attr) for k, (fn, attr) in KERNELS.items()}
    logits, _ = eng.prefill(ids)
    res = dict(tokens=out, logits=logits[:, -1].float().cpu().numpy(),
               prefill_s=st.prefill_seconds,
               decode_tok_s=st.decode_tokens_per_second,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts)
    del eng
    torch.cuda.empty_cache()
    return res


def _first_divergence(a, b):
    d = np.nonzero((np.asarray(a) != np.asarray(b)).any(axis=0))[0]
    return None if d.size == 0 else int(d[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layouts", default="tp4,dp2tp2,sp4,pp4")
    p.add_argument("--prompt", type=int, default=32768)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--gen", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    world = init_dist("nccl")
    me = world.rank
    try:
        cfg = llama31_8b("meta-llama/Llama-3.1-8B-Instruct",
                         dtype=torch.bfloat16)
        params = init_synthetic_params(
            cfg, torch.Generator(device="cuda").manual_seed(args.seed),
            device="cuda")
        ids = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, (args.batch, args.prompt))
        smi = _smi()
        refs = {}
        for fused in (True, False):
            if me == 0:
                refs[fused] = _run(cfg, params, ids, {}, fused, args.gen)
            dist.barrier()
        lines = []
        if me == 0:
            for fused, r in refs.items():
                lines.append(dict(
                    layout="single", path="fused" if fused else "xla-gather",
                    device=smi, prefill_s=r["prefill_s"],
                    decode_tok_s=r["decode_tok_s"], peak_gib=[r["peak_gib"]],
                    launches=[r["launches"]]))
        for name in args.layouts.split(","):
            axes = LAYOUTS[name]
            fused = not (axes.get("sp") or axes.get("pp"))
            t0 = time.perf_counter()
            r = _run(cfg, params, ids, axes, fused, args.gen)
            every = [None] * world.world_size
            dist.all_gather_object(every, dict(
                peak=r["peak_gib"], launches=r["launches"],
                smi=_smi()))
            if me == 0:
                ref = refs[fused]
                rel = float(np.abs(r["logits"] - ref["logits"]).max()
                            / np.abs(ref["logits"]).max())
                lines.append(dict(
                    layout=name, axes=axes,
                    path="fused" if fused else "xla-gather",
                    devices=[e["smi"] for e in every],
                    prefill_s=r["prefill_s"], decode_tok_s=r["decode_tok_s"],
                    single_decode_tok_s=ref["decode_tok_s"],
                    single_prefill_s=ref["prefill_s"],
                    logits_rel_err=rel,
                    first_divergence=_first_divergence(r["tokens"],
                                                       ref["tokens"]),
                    peak_gib=[e["peak"] for e in every],
                    launches=[e["launches"] for e in every],
                    run_s=time.perf_counter() - t0))
        if me == 0:
            for ln in lines:
                text = json.dumps(ln)
                print(text, flush=True)
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".",
                                exist_ok=True)
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
    finally:
        close_dist(world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
